"""Collectives of the layouts, their transport, and the four-axis topology.

Every collective of the port goes through this module, so that the
transport of a group is decided once, when the process group is created,
from the ranks' devices (:func:`choose_transport`):

* each rank on a card of its own, or the CPU: the tensors go to the
  backend as they are (NCCL on CUDA, gloo on the CPU);
* ranks that share a card (NCCL answers two ranks of one communicator on
  one GPU with ``invalid usage``): the world is a gloo group and each CUDA
  tensor is staged through the host — copied into a reused page-locked
  buffer, reduced, gathered or sent there by gloo, and copied back. On an
  H100, gloo took CUDA tensors of two such ranks in ``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
  ``all_to_all_single``, and its ``batch_isend_irecv`` (the pipeline's
  and the ring's exchange) ended the pair (``chip_smoke.py``'s probe).
  Every collective is staged all the same, so that one rule holds for
  every op; gloo's own CUDA path copies through the host as well, and the
  two were not timed against each other. This is the one-card stand-in
  for a multi-card run; it shows that each rank's code runs and that the
  values agree, not the speed of the layout over NCCL.

Reductions of floating tensors run in f32 and round back to the tensor's
type once. Every backend runs the same collectives (a gather is
``all_gather_into_tensor``, a reduce-scatter ``reduce_scatter_tensor``),
so the CPU's gloo runs the code that NCCL runs. The autograd functions
are Megatron-LM's region markers: :func:`copy_to` (identity forward, sum
of the gradients over the group backward), :func:`reduce_from` (sum
forward, identity backward), :func:`scatter_to` (this rank's block of the
last dimension forward, the blocks' gradients all-gathered backward) and
:func:`shift` (a ring step of a pipeline: send to the next rank, receive
from the previous one; the gradient travels the other way).

:class:`Topology` is JAX ``get_mesh``'s layout of ranks over the axes
``(data, model, seq, pipe)``, data outermost: rank ``((d·mp + m)·sp +
s)·pp + p``. An axis of degree 1 is absent; the data axis takes the rest
of the world. Every rank creates every axis group, in one fixed order.
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

__all__ = ["AXES", "Topology", "mesh_shape", "choose_transport",
           "host_staged", "transport_name", "all_reduce", "all_gather",
           "reduce_scatter", "gather_to_host", "broadcast", "send_recv",
           "copy_to", "reduce_from", "scatter_to", "shift"]

AXES = ("data", "model", "seq", "pipe")

_HOST_STAGED = False  # ranks share a card: CUDA tensors go through the host
_TRANSPORT = "none"


def choose_transport(identities: list, cuda: bool) -> str:
    """The backend for a world whose ranks run on ``identities`` (one
    ``host/card`` string a rank): ``nccl`` when every rank has a card of
    its own, ``gloo`` with host staging when two share one, ``gloo`` on
    the CPU. Sets the staging of this process's collectives."""
    global _HOST_STAGED, _TRANSPORT
    if not cuda:
        _HOST_STAGED, _TRANSPORT = False, "gloo"
        return "gloo"
    shared = len(set(identities)) < len(identities)
    _HOST_STAGED = shared
    _TRANSPORT = "gloo-host-staged" if shared else "nccl"
    return "gloo" if shared else "nccl"


def device_identity(rank: int) -> str:
    """``host/card`` of the card rank ``rank`` takes (rank modulo the
    host's cards, as the trainer assigns them)."""
    index = rank % max(torch.cuda.device_count(), 1)
    return f"{socket.gethostname()}/{index}"


def host_staged() -> bool:
    return _HOST_STAGED


def transport_name() -> str:
    """``nccl``, ``gloo`` (CPU), ``gloo-host-staged`` (ranks sharing a
    card) or ``none`` (one process)."""
    return _TRANSPORT


def reset_transport() -> None:
    global _HOST_STAGED, _TRANSPORT
    _HOST_STAGED, _TRANSPORT = False, "none"


def _staged(t: torch.Tensor) -> bool:
    return _HOST_STAGED and t.is_cuda


_PINNED: dict = {}  # (shape, dtype, slot) -> a page-locked staging buffer


def _pinned(shape, dtype, slot: int) -> torch.Tensor:
    key = (tuple(shape), dtype, slot)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return buf


def _to_host(t: torch.Tensor, slot: int = 0) -> torch.Tensor:
    """``t`` on the host: a reused page-locked buffer when ``t`` is a CUDA
    tensor to stage (a synchronous copy, so the buffer is free again once
    its result is copied back), else ``t`` itself."""
    if not _staged(t):
        return t
    buf = _pinned(t.shape, t.dtype, slot)
    buf.copy_(t)
    return buf


def _out_like(t: torch.Tensor, shape, slot: int) -> torch.Tensor:
    """An uninitialised tensor of ``shape`` and ``t``'s type for a
    collective's result: a reused page-locked buffer when ``t`` is staged,
    else on ``t``'s device."""
    if not _staged(t):
        return torch.empty(shape, dtype=t.dtype, device=t.device)
    return _pinned(shape, t.dtype, slot)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over ``group`` (a new tensor, ``t``'s type;
    floating tensors reduce in f32)."""
    work = (t.float() if t.is_floating_point() else t.clone()).contiguous()
    host = _to_host(work)
    dist.all_reduce(host, op=_OPS[op], group=group)
    return host.to(t.device).to(t.dtype)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in group
    rank order."""
    src = t.movedim(dim, 0).contiguous()
    size = dist.get_world_size(group)
    out = _out_like(src, (size * src.shape[0], *src.shape[1:]), 2)
    dist.all_gather_into_tensor(out, _to_host(src, 1), group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block (along ``dim``, in group rank order) of the sum of
    ``t`` over ``group``, in f32 for floating tensors, ``t``'s type."""
    size = dist.get_world_size(group)
    work = t.float() if t.is_floating_point() else t
    src = work.movedim(dim, 0).contiguous()
    out = _out_like(src, (src.shape[0] // size, *src.shape[1:]), 2)
    dist.reduce_scatter_tensor(out, _to_host(src, 1), group=group)
    return out.to(t.device).movedim(0, dim).contiguous().to(t.dtype)


def gather_to_host(t: torch.Tensor, group, dst: int, dim: int = 0):
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in group
    rank order, on the host of global rank ``dst`` (``None`` on the other
    ranks). Over gloo each block travels from the host (a CPU tensor, or
    a staged copy of a CUDA one); over NCCL the blocks land on ``dst``'s
    card, one leaf's worth, and are copied to its host there."""
    src = t.movedim(dim, 0).contiguous()
    if dist.get_backend(group) != "nccl":
        src = src.cpu()  # ldt: ignore[LDT1714] -- a checkpoint's leaf, bound for the host
    mine = dist.get_rank() == dst
    parts = ([torch.empty_like(src)
              for _ in range(dist.get_world_size(group))] if mine else None)
    dist.gather(src, parts, dst=dst, group=group)
    if not mine:
        return None
    return torch.cat([part.cpu() for part in parts]).movedim(
        0, dim).contiguous()


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``."""
    work = t.contiguous()
    host = _to_host(work) if _staged(work) else work.clone()
    dist.broadcast(host, src=src, group=group)
    return host.to(t.device, copy=True)


def send_recv(t: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``t`` to global rank ``to`` and receive a tensor of its shape
    and type from global rank ``frm``, at once (one batch of p2p ops)."""
    work = t.contiguous()
    host = _to_host(work, 3)
    recv = _out_like(work, work.shape, 4)
    ops = [dist.P2POp(dist.isend, host, to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for work_ in dist.batch_isend_irecv(ops):
        work_.wait()
    return recv.to(t.device, copy=True)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size, index = dist.get_world_size(group), dist.get_rank(group)
        n = x.shape[-1] // size
        return x.narrow(-1, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, grad.dim() - 1), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, nxt, prev):
        ctx.group, ctx.nxt, ctx.prev = group, nxt, prev
        return send_recv(x, nxt, prev, group)

    @staticmethod
    def backward(ctx, grad):
        return send_recv(grad, ctx.prev, ctx.nxt, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region that ``group`` computes in parts: identity forward,
    the gradients summed over the group backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave such a region: the parts summed (in f32) forward, identity
    backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def scatter_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region that ``group`` computes in parts from a tensor every
    rank of it holds whole: this rank's contiguous block of the last
    dimension forward (in group rank order), the blocks' gradients
    all-gathered into the whole gradient backward."""
    return x if group is None else _ScatterTo.apply(x, group)


def shift(x: torch.Tensor, group, nxt: int, prev: int) -> torch.Tensor:
    """One hop down a ring: ``x`` goes to global rank ``nxt``, the result
    comes from ``prev``; backward, the gradient goes the other way."""
    return _Shift.apply(x, group, nxt, prev)


def mesh_shape(world: int, model: int = 1, seq: int = 1,
               pipe: int = 1) -> dict:
    """``{axis: size}`` of JAX ``get_mesh`` over ``world`` devices, with
    its errors; absent axes have size 1."""
    if model < 1 or seq < 1 or pipe < 1:
        raise ValueError(f"parallelism degrees must be >=1, got mp={model} "
                         f"sp={seq} pp={pipe}")
    if world % (model * seq * pipe):
        raise ValueError(f"{world} devices not divisible by model*seq*pipe "
                         f"parallelism={model * seq * pipe}")
    return {"data": world // (model * seq * pipe), "model": model,
            "seq": seq, "pipe": pipe}


class Topology:
    """This rank's place on the mesh: ``index[axis]``, ``size[axis]``,
    ``group[axis]`` (``None`` for an axis of size 1, or outside a process
    group) and ``ranks[axis]`` (the global ranks of its group, in axis
    order). ``batch_group`` spans the axes that split the batch, data and
    seq (ranks holding the same model shard and pipeline stage): losses
    are means over it and replicated gradients are averaged over it."""

    def __init__(self, rank: int, world: int, model: int = 1, seq: int = 1,
                 pipe: int = 1, create_groups: bool = True):
        self.rank, self.world = rank, world
        self.size = mesh_shape(world, model, seq, pipe)
        strides, step = {}, 1
        for axis in reversed(AXES):
            strides[axis] = step
            step *= self.size[axis]
        self.strides = strides
        self.index = {a: (rank // strides[a]) % self.size[a] for a in AXES}
        self.group: dict = {a: None for a in AXES}
        self.ranks: dict = {a: [rank] for a in AXES}
        self.batch_group, self.batch_ranks = None, [rank]
        if create_groups and world > 1:
            self._create()

    def _members(self, base: int, axes) -> list:
        """Global ranks that differ from ``base`` only along ``axes``."""
        out = [base]
        for axis in axes:
            out = [r + i * self.strides[axis] for r in out
                   for i in range(self.size[axis])]
        return sorted(out)

    def _bases(self, axes) -> list:
        """The lowest rank of each group spanning ``axes``, in rank order."""
        return [r for r in range(self.world)
                if all((r // self.strides[a]) % self.size[a] == 0
                       for a in axes)]

    def _create(self) -> None:
        for key, axes in ([(a, (a,)) for a in AXES]
                          + [("batch", ("data", "seq"))]):
            if math.prod(self.size[a] for a in axes) == 1:
                continue
            for base in self._bases(axes):
                members = self._members(base, axes)
                group = dist.new_group(members)
                if self.rank in members:
                    if key == "batch":
                        self.batch_group, self.batch_ranks = group, members
                    else:
                        self.group[key], self.ranks[key] = group, members

    @property
    def batch_size(self) -> int:
        return len(self.batch_ranks)
