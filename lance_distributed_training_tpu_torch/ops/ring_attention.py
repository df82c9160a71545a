"""K5 — ring attention's block fold: the hand-written kernels and their
plain versions.

Counterpart of ``_block_attn`` in
``lance_distributed_training_tpu/parallel/ring_attention.py`` (:37), the
fold that ``ring_attention``'s loop (:62) runs once per ring step, and of
the backward JAX takes through that loop by autodiff.
:func:`block_attn_reference` repeats ``_block_attn`` operation for
operation, in the same order and with the same rounding points (the
``einsum`` of two bf16 arrays yields bf16; the scale ``1/sqrt(D)`` divides
in f32 after that rounding; masked scores take ``finfo(f32).min`` and ``p``
is then multiplied by the mask).

Three kernels in ``csrc/ring_attn.cu`` (sm_90a), each with its plain
version here, take every query position a process holds in one launch:
``P`` positions of one in-process ring, or ``P = 1`` for a process ring.
At ring step ``shift``, query block ``i`` folds key block
``(i - shift) mod P``. Each kernel folds ``steps`` ring steps from
``shift`` in one launch, exactly as ``steps`` one-step launches would.

* ``ring_fwd`` (``wgmma``, TMA): with ``acc`` the f32 carries
  ``(m, l, acc)`` are read and updated in place; with ``acc=None`` the
  launch starts from fresh carries, held on chip, and writes only the final
  ``m`` and ``l``. With ``out`` it also writes ``bf16(acc / max(l,
  1e-30))``, the ring's output after its last step.
* ``ring_bwd_dq`` (``wgmma``, TMA): adds each step's f32 dQ onto the
  resident queries' totals, in ring-step order; with ``dq=None`` the
  totals start at zero, and ``out`` takes them in q's type.
* ``ring_bwd_dkv`` (``wgmma``, TMA): adds each step's f32 dK/dV onto the
  travelling block's totals, in ring-step order; with ``dk=dv=None`` the
  totals start at zero, and ``out=(dk, dv)`` takes them in q's type.

The backward takes ``lse = m + log(l)`` (0 where ``l = 0``) and
``delta = rowsum(dO * O)``; :func:`block_attn_bwd_reference` writes out the
derivative that autodiff takes through the fold: ``P = exp(s - lse)`` at
valid keys, ``dS = P (dP - delta)``, the ``1/sqrt(D)`` and the casts passed
through.

The wrappers route by the device of their inputs: CPU tensors take the
plain versions, CUDA tensors launch the kernels or raise (head dim 64,
bf16). ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from ..utils import compiletrack

__all__ = [
    "HEAD_DIM",
    "LAUNCHES",
    "MASK_FILL",
    "block_attn_reference",
    "block_attn_bwd_reference",
    "finalize",
    "row_lse",
    "ring_fold_fwd",
    "ring_fold_fwd_reference",
    "ring_fold_bwd_dq",
    "ring_fold_bwd_dq_reference",
    "ring_fold_bwd_dkv",
    "ring_fold_bwd_dkv_reference",
]

HEAD_DIM = 64
MASK_FILL = float(torch.finfo(torch.float32).min)
LAUNCHES = {"ring_fwd": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}

_SOURCE = "ring_attn"
_lib: Optional[ctypes.CDLL] = None


# ------------------------------------------------------------ plain versions


def _scores(q, k, mask_block):
    """``q k^T`` in the inputs' type, then f32 over ``sqrt(D)``; masked keys
    take ``finfo(f32).min``."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    scores = scores / math.sqrt(q.shape[-1])
    if mask_block is not None:
        scores = torch.where(mask_block, scores, MASK_FILL)
    return scores


def block_attn_reference(q, k, v, m_prev, l_prev, acc, mask_block=None):
    """Fold one K/V block into the running statistics, as ``_block_attn``.

    q ``[B,H,Sq,D]``; k, v ``[B,H,Sk,D]``; m_prev, l_prev ``[B,H,Sq]`` f32;
    acc ``[B,H,Sq,D]`` f32; mask_block ``[B,1,1,Sk]`` bool. Returns
    ``(m_new, l_new, acc)``."""
    scores = _scores(q, k, mask_block)
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))
    scale = torch.exp(m_prev - m_new)
    p = torch.exp(scores - m_new[..., None])
    if mask_block is not None:
        # When a whole block is masked, m_new equals the fill value and
        # exp(scores - m_new) would be 1, not 0.
        p = p * mask_block.to(p.dtype)
    l_new = l_prev * scale + p.sum(dim=-1)
    acc = acc * scale[..., None] + torch.matmul(p.to(v.dtype), v).float()
    return m_new, l_new, acc


def finalize(acc, l, dtype):
    """The ring's output: ``acc / max(l, 1e-30)`` in ``dtype``."""
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def row_lse(m, l):
    """``m + log(l)`` per row, 0 where ``l = 0`` (no valid key)."""
    return torch.where(l > 0, m + torch.log(l), torch.zeros_like(m))


def block_attn_bwd_reference(q, k, v, mask_block, lse, delta, do):
    """One block's ``(dq, dk, dv)``, f32: the derivative of the fold's
    share of the output, ``P = exp(s - lse)`` at the block's valid keys,
    with ``lse`` and ``delta = rowsum(dO * O)`` of the whole ring."""
    scores = _scores(q, k, mask_block)
    p = torch.exp(scores - lse[..., None])
    if mask_block is not None:
        p = torch.where(mask_block, p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) / math.sqrt(q.shape[-1])).to(q.dtype)
    ds = ds.float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    return dq, dk, dv


def _rows(t: torch.Tensor, index: int, block: int) -> torch.Tensor:
    """Rows ``[index*block, (index+1)*block)`` of dim 2 (``[B,H,S,...]``)."""
    return t[:, :, index * block:(index + 1) * block]


def _block(t: torch.Tensor, index: int, block: int) -> torch.Tensor:
    return _rows(t, index, block).contiguous()


def _mask_block(mask: torch.Tensor, index: int, block: int) -> torch.Tensor:
    """Key-validity block ``[B,1,1,block]`` of a ``[B, S]`` mask."""
    return mask[:, index * block:(index + 1) * block].bool()[:, None, None, :]


def _positions(q, positions: int) -> int:
    if positions < 1 or q.shape[2] % positions:
        raise ValueError(f"sequence {q.shape[2]} does not split into "
                         f"{positions} ring positions")
    return q.shape[2] // positions


def _fold_fwd_step(q, k, v, mask, m, l, acc, positions, shift, out):
    sb = _positions(q, positions)
    for i in range(positions):
        j = (i - shift) % positions
        m_i, l_i, acc_i = block_attn_reference(
            _block(q, i, sb), _block(k, j, sb), _block(v, j, sb),
            _rows(m, i, sb), _rows(l, i, sb), _rows(acc, i, sb),
            _mask_block(mask, j, sb))
        _rows(m, i, sb).copy_(m_i)
        _rows(l, i, sb).copy_(l_i)
        _rows(acc, i, sb).copy_(acc_i)
        if out is not None:
            _rows(out, i, sb).copy_(finalize(acc_i, l_i, out.dtype))


def ring_fold_fwd_reference(q, k, v, mask, m, l, acc, positions: int,
                            shift: int, out=None, steps: int = 1) -> None:
    """Plain ring steps ``shift, ..., shift + steps - 1``, in order: at
    step ``t`` each query block ``i`` folds key block
    ``(i - t) mod positions`` (:func:`block_attn_reference`), in place on
    ``m``, ``l``, ``acc``; with ``acc=None`` the carries start fresh (``m``
    and ``l`` are written, not read). ``out`` takes :func:`finalize` of the
    carries after the last step."""
    if acc is None:
        m.fill_(float("-inf"))
        l.zero_()
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t in range(shift, shift + steps):
        _fold_fwd_step(q, k, v, mask, m, l, acc, positions, t,
                       out if t == shift + steps - 1 else None)


def ring_fold_bwd_dq_reference(q, k, v, mask, lse, delta, do, dq,
                               positions: int, shift: int, steps: int = 1,
                               out=None) -> None:
    """Plain dQ steps ``shift, ..., shift + steps - 1``, in order: at step
    ``t`` query block ``i`` adds the dQ of key block
    ``(i - t) mod positions`` to the f32 totals ``dq`` (in place), or to
    zeros when it is None; ``out`` takes the totals in its own type."""
    sb = _positions(q, positions)
    if dq is None:
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t in range(shift, shift + steps):
        for i in range(positions):
            j = (i - t) % positions
            dq_i, _, _ = block_attn_bwd_reference(
                _block(q, i, sb), _block(k, j, sb), _block(v, j, sb),
                _mask_block(mask, j, sb), _rows(lse, i, sb),
                _rows(delta, i, sb), _block(do, i, sb))
            _rows(dq, i, sb).add_(dq_i)
    if out is not None:
        out.copy_(dq)


def ring_fold_bwd_dkv_reference(q, k, v, mask, lse, delta, do, dk, dv,
                                positions: int, shift: int, steps: int = 1,
                                out=None) -> None:
    """Plain dK/dV steps ``shift, ..., shift + steps - 1``, in order: at
    step ``t`` key block ``j`` adds what query block
    ``(j + t) mod positions`` gives it to the f32 totals ``dk``/``dv`` (in
    place), or to zeros when they are None; ``out = (dk_out, dv_out)``
    takes the totals in its own type."""
    sb = _positions(q, positions)
    if dk is None:
        dk = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
    for t in range(shift, shift + steps):
        for j in range(positions):
            i = (j + t) % positions
            _, dk_j, dv_j = block_attn_bwd_reference(
                _block(q, i, sb), _block(k, j, sb), _block(v, j, sb),
                _mask_block(mask, j, sb), _rows(lse, i, sb),
                _rows(delta, i, sb), _block(do, i, sb))
            _rows(dk, j, sb).add_(dk_j)
            _rows(dv, j, sb).add_(dv_j)
    if out is not None:
        out[0].copy_(dk)
        out[1].copy_(dv)


# ------------------------------------------------------------ kernels


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``ring_attn.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldt_ring_fold_fwd.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.ldt_ring_fold_bwd_dq.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.ldt_ring_fold_bwd_dkv.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
    for fn in (lib.ldt_ring_fold_fwd, lib.ldt_ring_fold_bwd_dq,
               lib.ldt_ring_fold_bwd_dkv):
        fn.restype = ctypes.c_int
    lib.ldt_ring_error_string.argtypes = [ctypes.c_int]
    lib.ldt_ring_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind_library(_build.load_library(_SOURCE))
    return _lib


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return False
    raise RuntimeError(f"ring attention has no kernel for device {q.device}")


def _check_steps(name: str, positions: int, shift: int, steps: int) -> None:
    if not 0 <= shift < positions:
        raise ValueError(f"{name}: shift {shift} outside [0, {positions})")
    if steps < 1 or shift + steps > positions:
        raise ValueError(f"{name}: steps {steps} from shift {shift} outside "
                         f"[1, {positions - shift}]")


def _check(name: str, q, k, v, mask, positions: int, shift: int,
           steps: int = 1, bf16=(), f32_rows=(), f32_full=()) -> tuple:
    """Validate a CUDA launch's inputs (entries that are None are not
    passed); returns ``(B, H, Sb)``."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, D], got "
                         f"{tuple(q.shape)}")
    b, h, s, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} not supported (the kernels "
                         f"are built for {HEAD_DIM})")
    sb = _positions(q, positions)
    _check_steps(name, positions, shift, steps)
    tensors = [("q", q, torch.bfloat16, q.shape), ("k", k, torch.bfloat16,
                                                   q.shape),
               ("v", v, torch.bfloat16, q.shape),
               ("mask", mask, torch.uint8, (b, s))]
    tensors += [(n, t, torch.bfloat16, q.shape) for n, t in bf16]
    tensors += [(n, t, torch.float32, (b, h, s)) for n, t in f32_rows]
    tensors += [(n, t, torch.float32, q.shape) for n, t in f32_full]
    for t_name, t, dtype, shape in tensors:
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {t_name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t_name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")
    return b, h, sb


def _launch(name: str, fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        pointers = [None if a is None else
                    (a.data_ptr() if isinstance(a, torch.Tensor) else a)
                    for a in args]
        code = fn(*pointers, stream)
    if code != 0:
        msg = _library().ldt_ring_error_string(code).decode()
        raise RuntimeError(f"ring attention {name} launch failed: {msg} "
                           f"(code {code})")
    LAUNCHES[name] += 1


def ring_fold_fwd(q, k, v, mask, m, l, acc, positions: int = 1,
                  shift: int = 0, out=None, *, steps: int = 1) -> None:
    """Ring steps ``shift, ..., shift + steps - 1`` of the forward over
    every position ``q`` holds, on the f32 carries ``m``, ``l``
    (``[B,H,S]``) and ``acc`` (``[B,H,S,D]``), updated in place; with
    ``acc=None`` the carries start fresh and only ``m`` and ``l`` are
    written. ``out`` (``q``'s type), when given, takes the output after the
    last step. ``mask`` is the uint8 key validity ``[B, S]``. CUDA: one
    launch of the ``ring_fwd`` kernel. CPU: :func:`ring_fold_fwd_reference`."""
    if compiletrack.enabled():
        # The ring step (shift) is a kernel argument, not a launch
        # configuration: it is left out of the signature.
        compiletrack.track_launch(q, k, v, mask, m, l, acc, positions, out,
                                  steps=steps)
    if _on_cpu(q):
        _check_steps("ring_fwd", positions, shift, steps)
        ring_fold_fwd_reference(q, k, v, mask, m, l, acc, positions, shift,
                                out, steps)
        return
    b, h, sb = _check("ring_fwd", q, k, v, mask, positions, shift, steps,
                      bf16=[("out", out)], f32_rows=[("m", m), ("l", l)],
                      f32_full=[("acc", acc)])
    _launch("ring_fwd", _library().ldt_ring_fold_fwd, q, k, v, mask, m, l,
            acc, out, b, h, positions, sb, q.shape[-1], shift, steps)


def ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq, positions: int = 1,
                     shift: int = 0, *, steps: int = 1, out=None) -> None:
    """Ring steps ``shift, ..., shift + steps - 1`` of dQ, each step's
    contribution added in turn to the f32 totals ``dq`` (in place), or to
    zeros when it is None; ``out`` (``q``'s type) takes the final totals.
    CUDA: one launch of the ``ring_bwd_dq`` kernel. CPU:
    :func:`ring_fold_bwd_dq_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(q, k, v, mask, lse, delta, do, dq,
                                  positions, steps=steps, out=out)
    if dq is None and out is None:
        raise ValueError("ring_bwd_dq: give dq, or out, or both")
    if _on_cpu(q):
        _check_steps("ring_bwd_dq", positions, shift, steps)
        ring_fold_bwd_dq_reference(q, k, v, mask, lse, delta, do, dq,
                                   positions, shift, steps, out)
        return
    b, h, sb = _check("ring_bwd_dq", q, k, v, mask, positions, shift, steps,
                      bf16=[("do", do), ("out", out)],
                      f32_rows=[("lse", lse), ("delta", delta)],
                      f32_full=[("dq", dq)])
    _launch("ring_bwd_dq", _library().ldt_ring_fold_bwd_dq, q, k, v, mask,
            lse, delta, do, dq, out, b, h, positions, sb, q.shape[-1], shift,
            steps)


def ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, dk, dv,
                      positions: int = 1, shift: int = 0, *, steps: int = 1,
                      out=None) -> None:
    """Ring steps ``shift, ..., shift + steps - 1`` of dK/dV, each step's
    contribution added in turn to the f32 totals ``dk``/``dv`` (in place),
    or to zeros when both are None; ``out = (dk_out, dv_out)`` (``q``'s
    type) takes the final totals. CUDA: one launch of the ``ring_bwd_dkv``
    kernel. CPU: :func:`ring_fold_bwd_dkv_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(q, k, v, mask, lse, delta, do, dk, dv,
                                  positions, steps=steps, out=out)
    if (dk is None) != (dv is None) or (dk is None and out is None):
        raise ValueError("ring_bwd_dkv: give dk and dv, or out, or both")
    if _on_cpu(q):
        _check_steps("ring_bwd_dkv", positions, shift, steps)
        ring_fold_bwd_dkv_reference(q, k, v, mask, lse, delta, do, dk, dv,
                                    positions, shift, steps, out)
        return
    dk_out, dv_out = out if out is not None else (None, None)
    b, h, sb = _check("ring_bwd_dkv", q, k, v, mask, positions, shift, steps,
                      bf16=[("do", do), ("dk_out", dk_out),
                            ("dv_out", dv_out)],
                      f32_rows=[("lse", lse), ("delta", delta)],
                      f32_full=[("dk", dk), ("dv", dv)])
    _launch("ring_bwd_dkv", _library().ldt_ring_fold_bwd_dkv, q, k, v, mask,
            lse, delta, do, dk, dv, dk_out, dv_out, b, h, positions, sb,
            q.shape[-1], shift, steps)
