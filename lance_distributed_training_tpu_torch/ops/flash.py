"""Flash attention — the hand-written Hopper kernels and their plain versions.

Counterpart of ``lance_distributed_training_tpu/ops/flash.py``, which calls
the Pallas TPU kernel ``jax.experimental.pallas.ops.tpu.flash_attention``.
Here the forward, dQ and dK/dV passes are CUDA kernels written for sm_90a
(``csrc/flash_attn.cu``; all three through wgmma, a TMA ring and a
producer warpgroup) with the Pallas kernel's semantics:

* a query attends a key iff their segment ids are equal (and, when causal,
  the key does not come after the query); a key-validity mask ``[B,1,1,S]``
  is lowered to segment ids (valid 1, padding 0), so padding queries attend
  padding keys and their outputs are dead (the loss masks them);
* masking is additive with ``MASK_VALUE = -0.7 * finfo(float32).max``;
* the scale ``1/sqrt(D)`` multiplies ``QK^T`` before the mask.

Each kernel wrapper routes by the device of its inputs: tensors on the CPU
take the plain PyTorch version beside it, CUDA tensors launch the kernel or
raise. ``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from ..utils import compiletrack

__all__ = [
    "LAUNCHES",
    "MASK_VALUE",
    "TILES",
    "segment_attention_mask",
    "flash_attention_reference",
    "flash_attention_bwd_dq_reference",
    "flash_attention_bwd_dkv_reference",
    "flash_attention_fwd",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "flash_attention",
    "make_flash_attention",
]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# (query rows, key rows) of one tile of each kernel, by head dim, fixed when
# csrc/flash_attn.cu is compiled (FwdCfg, DqCfg and DkvCfg).
TILES = {
    "fwd": {64: (128, 128), 128: (128, 64)},
    "bwd_dq": {64: (128, 128), 128: (128, 64)},
    "bwd_dkv": {64: (64, 128), 128: (64, 128)},
}
HEAD_DIMS = (64, 128)
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

_SOURCE = "flash_attn"
_lib: Optional[ctypes.CDLL] = None


def segment_attention_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` segment ids (1-based; 0 = padding) → boolean
    ``[B, 1, S, S]``: query q may attend key k iff both lie in the same live
    segment. The dense-attention form of segment masking."""
    seg = segment_ids.to(torch.int32)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    live = (seg > 0)[:, None, None, :]
    return same & live


# ------------------------------------------------------------ plain versions


def _mask_bias(segment_ids: Optional[torch.Tensor], s_q: int, s_k: int,
               causal: bool, device) -> Optional[torch.Tensor]:
    """Additive f32 mask ``[B or 1, 1, Sq, Sk]``: 0 where attention is
    allowed, ``MASK_VALUE`` elsewhere; ``None`` when nothing is masked."""
    allowed = None
    if segment_ids is not None:
        seg = segment_ids.to(device=device, dtype=torch.int32)
        allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
    if causal:
        tri = torch.ones(s_q, s_k, dtype=torch.bool, device=device).tril()
        tri = tri[None, None]
        allowed = tri if allowed is None else allowed & tri
    if allowed is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=device)
    mask = torch.full((), MASK_VALUE, dtype=torch.float32, device=device)
    return torch.where(allowed, zero, mask)


def _scores(q, k, segment_ids, causal, sm_scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    bias = _mask_bias(segment_ids, q.shape[2], k.shape[2], causal, q.device)
    return s if bias is None else s + bias


def flash_attention_reference(q, k, v, segment_ids=None, causal=False,
                              sm_scale=1.0):
    """Plain PyTorch forward, computed in f32: ``(o, lse)`` with ``o`` in
    ``q``'s dtype and ``lse = m + log(l)`` f32 ``[B, H, S]``. The same
    arithmetic as upstream's ``mha_reference_no_custom_vjp``."""
    s = _scores(q, k, segment_ids, causal, sm_scale)
    m = s.amax(dim=-1)
    unnormalized = torch.exp(s - m[..., None])
    denom = unnormalized.sum(dim=-1)
    o = torch.matmul(unnormalized / denom[..., None], v.float())
    return o.to(q.dtype), m + torch.log(denom)


def _probs_and_ds(q, k, v, segment_ids, lse, do, di, causal, sm_scale):
    p = torch.exp(_scores(q, k, segment_ids, causal, sm_scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di[..., None])


def flash_attention_bwd_dq_reference(q, k, v, segment_ids, lse, do, di,
                                     causal=False, sm_scale=1.0):
    """Plain dQ from the forward's ``lse`` and ``di = rowsum(o * do)``."""
    _, ds = _probs_and_ds(q, k, v, segment_ids, lse, do, di, causal, sm_scale)
    return (torch.matmul(ds, k.float()) * sm_scale).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, segment_ids, lse, do, di,
                                      causal=False, sm_scale=1.0):
    """Plain ``(dK, dV)`` from the forward's ``lse`` and ``di``."""
    p, ds = _probs_and_ds(q, k, v, segment_ids, lse, do, di, causal, sm_scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernels


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``flash_attn.cu``."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldt_flash_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [f32, ptr]
    lib.ldt_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 5 + [f32, ptr]
    lib.ldt_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 5 + [f32, ptr]
    for fn in (lib.ldt_flash_fwd, lib.ldt_flash_bwd_dq, lib.ldt_flash_bwd_dkv):
        fn.restype = ctypes.c_int
    lib.ldt_flash_error_string.argtypes = [ctypes.c_int]
    lib.ldt_flash_error_string.restype = ctypes.c_char_p
    lib.ldt_flash_smem_bytes.argtypes = [i32, i32]
    lib.ldt_flash_smem_bytes.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind_library(_build.load_library(_SOURCE))
    return _lib


def _check(name: str, q, k, v, segment_ids, extra_bf16=(), extra_f32=()):
    """Validate a CUDA launch's inputs; raise on anything the kernel does not
    take."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, D], got {tuple(q.shape)}")
    device = q.device
    for t_name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name}: {t_name} shape {tuple(t.shape)} != "
                             f"q shape {tuple(q.shape)}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported "
                         f"(kernels are built for {HEAD_DIMS})")
    for t_name, t in extra_bf16:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {t_name} shape {tuple(t.shape)} != "
                             f"q shape {tuple(q.shape)}")
    for t_name, t in extra_f32:
        if tuple(t.shape) != (b, h, s):
            raise ValueError(f"{name}: {t_name} must be [B, H, S] = "
                             f"{(b, h, s)}, got {tuple(t.shape)}")
    tensors = [("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
               ("v", v, torch.bfloat16)]
    tensors += [(n, t, torch.bfloat16) for n, t in extra_bf16]
    tensors += [(n, t, torch.float32) for n, t in extra_f32]
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, s):
            raise ValueError(f"{name}: segment_ids must be [B, S] = "
                             f"{(b, s)}, got {tuple(segment_ids.shape)}")
        tensors.append(("segment_ids", segment_ids, torch.int32))
    for t_name, t, dtype in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {t_name} on {t.device}, q on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t_name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")


def _launch(name: str, fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        msg = _library().ldt_flash_error_string(code).decode()
        raise RuntimeError(f"flash attention {name} launch failed: {msg} "
                           f"(code {code})")
    LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _device_kind(q: torch.Tensor) -> str:
    if q.device.type in ("cpu", "cuda"):
        return q.device.type
    raise RuntimeError(f"flash attention has no kernel for device {q.device}")


def flash_attention_fwd(q, k, v, segment_ids=None, causal=False,
                        sm_scale=1.0):
    """Forward pass: ``(o, lse)``. CUDA: the ``fwd`` kernel (bf16 in, bf16
    ``o`` and f32 ``lse`` out). CPU: :func:`flash_attention_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(q, k, v, segment_ids, causal, sm_scale)
    if _device_kind(q) == "cpu":
        return flash_attention_reference(q, k, v, segment_ids, causal, sm_scale)
    _check("fwd", q, k, v, segment_ids)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("fwd", _library().ldt_flash_fwd, _ptr(q), _ptr(k), _ptr(v),
                _ptr(segment_ids), _ptr(o), _ptr(lse), b, h, s, d,
                int(causal), float(sm_scale), stream)
    return o, lse


def flash_attention_bwd_dq(q, k, v, segment_ids, lse, do, di, causal=False,
                           sm_scale=1.0):
    """dQ. CUDA: the ``bwd_dq`` kernel. CPU:
    :func:`flash_attention_bwd_dq_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(
            q, k, v, segment_ids, lse, do, di, causal, sm_scale)
    if _device_kind(q) == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, segment_ids, lse, do,
                                                di, causal, sm_scale)
    _check("bwd_dq", q, k, v, segment_ids, extra_bf16=[("do", do)],
           extra_f32=[("lse", lse), ("di", di)])
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("bwd_dq", _library().ldt_flash_bwd_dq, _ptr(q), _ptr(k),
                _ptr(v), _ptr(segment_ids), _ptr(lse), _ptr(do), _ptr(di),
                _ptr(dq), b, h, s, d, int(causal), float(sm_scale), stream)
    return dq


def flash_attention_bwd_dkv(q, k, v, segment_ids, lse, do, di, causal=False,
                            sm_scale=1.0):
    """``(dK, dV)``. CUDA: the ``bwd_dkv`` kernel. CPU:
    :func:`flash_attention_bwd_dkv_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(
            q, k, v, segment_ids, lse, do, di, causal, sm_scale)
    if _device_kind(q) == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, segment_ids, lse,
                                                 do, di, causal, sm_scale)
    _check("bwd_dkv", q, k, v, segment_ids, extra_bf16=[("do", do)],
           extra_f32=[("lse", lse), ("di", di)])
    b, h, s, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("bwd_dkv", _library().ldt_flash_bwd_dkv, _ptr(q), _ptr(k),
                _ptr(v), _ptr(segment_ids), _ptr(lse), _ptr(do), _ptr(di),
                _ptr(dk), _ptr(dv), b, h, s, d, int(causal), float(sm_scale),
                stream)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward through the ``fwd`` kernel; backward computes
    ``di = rowsum(o * do)`` as a plain op (as upstream does outside its
    kernels) and launches the ``bwd_dq`` and ``bwd_dkv`` kernels."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, segment_ids, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        do = do.contiguous()
        di = (o.float() * do.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, segment_ids, lse, do, di,
                                    ctx.causal, ctx.sm_scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, segment_ids, lse, do, di,
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, segment_ids=None, causal=False,
                    sm_scale: Optional[float] = None):
    """Differentiable flash attention on ``[B, H, S, D]`` inputs."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), segment_ids, bool(causal),
                                 float(sm_scale))


def make_flash_attention(block_q: Optional[int] = None,
                         block_k: Optional[int] = None, causal: bool = False):
    """Build an ``attention_fn(q, k, v, mask=None, dtype=None,
    segment_ids=None)`` for :class:`..models.transformer.SelfAttention`.

    q/k/v are ``[B, H, S, D]``; ``mask`` is the key-validity mask
    ``[B, 1, 1, S]``, lowered to segment ids; ``segment_ids`` (packed
    sequences) supersedes it. The kernels' tiles are fixed per kernel and
    head dim when they are compiled (:data:`TILES`). Block sizes left at
    ``None`` take them; given ones must be the forward's tile for some head
    dim, and a call at another head dim raises."""
    fwd_tiles = TILES["fwd"]
    requested = (block_q, block_k)
    if requested != (None, None) and requested not in fwd_tiles.values():
        raise ValueError(
            f"block sizes {requested} not available: the forward kernel's "
            f"tiles are compiled as {fwd_tiles} (head dim: (q, k))"
        )

    def attention_fn(q, k, v, mask=None, dtype=None, segment_ids=None):
        d = q.shape[-1]
        if requested != (None, None) and fwd_tiles.get(d) != requested:
            raise ValueError(
                f"block sizes {requested} not available at head dim {d}: "
                f"the forward kernel's tiles are {fwd_tiles}"
            )
        seg = segment_ids
        if seg is None and mask is not None:
            seg = mask.reshape(mask.shape[0], mask.shape[-1])
        out = flash_attention(q, k, v, segment_ids=seg, causal=causal)
        return out.to(q.dtype)

    return attention_fn
