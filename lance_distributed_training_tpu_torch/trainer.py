"""The trainer: one ``train()`` over a pluggable input pipeline and task.

Counterpart of ``lance_distributed_training_tpu/trainer.py`` for image
classification (ResNet), masked-LM and causal-LM text: ``TrainConfig``
(the subset of the JAX flags these paths use, plus ``device``), the
learning-rate schedules, the optimizers (SGD with momentum, AdamW,
global-norm clipping), the train step, the weighted eval (``make_eval_step``, ``evaluate``) and the
loop. The loss stays on the device: per-step losses are fetched only at log
points and at the end, never with a per-step ``.item()``.

Device decode (``device_decode``, classification only): the loader ships
JPEG coefficient pages (``data/device_decode.py``) and K2
(``ops/jpeg_device.py``) turns them into the uint8 batch on the device,
after the H2D copy and before the step, for the train and the eval
batches alike; its device time is read from CUDA events at log points.

Token packing (``token_pack``, text tasks): the loader ships ragged token
pages and a first-fit-decreasing plan (``data/token_pack.py``), and K3
(``ops/token_device.py``) packs them into ``[rows, pack_len]`` grids with
segment and position ids on the device, after the H2D copy and before the
step; its device time is read as K2's is. The eval at the end always
streams the padded arm. The ``[metrics]`` lines of a text run give the grid
tokens/s, the valid tokens/s and ``pad_waste_pct``, each from the window's
own steps: a packed batch's payload is its plan's (the host header), a
padded batch's its attention mask's count.

Data parallelism: with ``coordinator_address``/``num_processes``/
``process_id`` each process joins a ``torch.distributed`` group, owns one
device, reads ``batch_size / world`` rows of each global batch through the
samplers' rank arguments, and trains a DDP replica whose BatchNorm takes
the global batch's statistics, as the JAX step does over its sharded batch.
A text loss is the global batch's weighted mean (``models/tasks.py``).

Sequence parallelism (``seq_parallelism``, masked-LM): attention runs as a
ring over ``seq_parallelism`` sequence blocks (``parallel/
ring_attention.py``, K5). One process holds every ring position on its
device. Across processes the ranks form JAX's ``('data', 'seq')`` mesh,
data outermost: the members of one ring read the same rows (sampler rank =
data index), share one MLM mask draw (seeded by the data index), and each
trains on its sequence block with its global ``position_ids``, the key and
value blocks passing between them; DDP spans the world. Rank 0 evaluates
alone, folding whole sequences in its process.

Beyond the main path, as the JAX trainer: gradient accumulation
(``grad_accum``, ``optax.MultiSteps``' semantics in :class:`TrainStep`),
crash-consistent step checkpoints with the data-plane cursor and resume
(``checkpoint_dir``, ``utils/checkpoint.py``; SIGTERM and the ``LDT_CHAOS``
hook drain through ``utils/signals.py`` and ``utils/chaos.py``), the eval
every N epochs over a held-out dataset (``eval_every``,
``val_dataset_path``), the micro-batch gradient norm and the lr in the
progress lines (``log_grad_norm``), and a ``torch.profiler`` window
(``profile_dir``, ``utils/profiling.py``).

The loaders, as the JAX trainer selects them: the iterable range plans
(``loader_style="iterable"``, the default), the map-style loader
(``loader_style="map"``: a ``DistributedSampler`` permutation each epoch,
rows gathered by ``Dataset.take``) with a row filter (``filter``) and a
seeded held-out fraction (``val_fraction``) resolved once a run to index
pools, and the file-based control arm (``data_format="folder"``: an
image-folder tree read file by file, in either style). Every arm feeds the
same decoders, so K1 (and K2 under ``device_decode``) run unchanged under
each.

The way from host to card, at the JAX trainer's defaults: the decoders
write into pooled pages (``buffer_pool``; page-locked on CUDA,
``data/buffers.py``), ``producer_threads`` threads decode the plan in
order, and the placement plane (``global_batch``, ``data/placement.py``)
places every train and eval batch on a side stream from its own thread,
``placement_depth`` batches ahead of the step; ``global_batch=False`` is
the synchronous control arm (``parallel/mesh.make_global_batch`` on the
consumer thread, or in the producers). ``pretrained`` starts the ResNet
from a torchvision checkpoint (``models/pretrained.py``), the reference's
fine-tuning task.

The device is the caller's choice: ``device="cuda"`` (the default) raises
when no card is present rather than falling back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import statistics
import time
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .data.buffers import default_buffer_pool
from .data.decode import decoder_for_task
from .data.authoring import _folder_samples
from .data.folder import FolderDataPipeline, read_sample_batch
from .data.format import Dataset
from .data.placement import PlacementPlane
from .data.pipeline import (
    make_eval_pipeline,
    make_map_style_pipeline,
    make_train_pipeline,
)
from .data.token_pack import TokenPackConfig, is_ragged_batch, pack_meta
from .models.pretrained import load_torch_state_dict, load_torchvision_resnet
from .models.resnet import set_sync_group
from .models.tasks import Task, draw_mlm_mask, get_task
from .ops.flash import make_flash_attention
from .ops.jpeg_device import make_batch_transform
from .ops.token_device import make_pack_transform
from .parallel.mesh import (
    maybe_initialize_distributed,
    new_seq_groups,
    process_topology,
    seq_topology,
    shutdown_distributed,
    sync_global_devices,
)
from .parallel.ring_attention import ProcessRing, make_ring_attention
from .utils.chaos import StepTrace, TrainerChaos
from .utils.checkpoint import CheckpointManager, pack_rng_key, unpack_rng_key
from .utils.metrics import MetricLogger, StepTimer
from .utils.profiling import ProfileWindow
from .utils.signals import PreemptionHandler

__all__ = [
    "TrainConfig",
    "train",
    "resolve_device",
    "lr_schedule_fn",
    "make_optimizer",
    "make_train_step",
    "TrainStep",
    "make_eval_step",
    "evaluate",
    "clip_by_global_norm_",
]

PORTED_TASKS = ("classification", "masked_lm", "causal_lm")
_TEXT_TASKS = ("masked_lm", "causal_lm", "contrastive")


@dataclasses.dataclass
class TrainConfig:
    """The JAX trainer's flags that the ported paths use, plus ``device``."""

    dataset_path: str
    val_dataset_path: Optional[str] = None  # held-out dataset for
    # eval_every and the eval at the end (else they read the train data)
    val_fraction: float = 0.0  # >0: a seeded held-out fraction of the train
    # dataset is the val split (torch random_split's train/val separation
    # without a second dataset). Map-style columnar path; composes with
    # filter (the split happens inside the filtered pool). Mutually
    # exclusive with val_dataset_path.
    task_type: str = "classification"
    num_classes: int = 101
    sampler_type: str = "batch"  # batch | fragment | full
    loader_style: str = "iterable"  # iterable | map (the two reference paths)
    filter: Optional[str] = None  # row predicate ("label < 50"), resolved to
    # an index pool once; map-style columnar path only (see data/filters.py)
    data_format: str = "columnar"  # columnar | folder (the file-based
    # control arm)
    batch_size: int = 512  # GLOBAL batch, across processes
    epochs: int = 10
    max_steps: int = 0  # >0: stop after N train steps regardless of epochs
    lr: float = 0.05
    momentum: float = 0.9
    optimizer: str = "sgd"  # sgd | adamw
    weight_decay: float = 0.0
    lr_schedule: str = "constant"  # constant | cosine (optional linear warmup)
    warmup_steps: int = 0
    total_steps: Optional[int] = None  # schedule horizon; None = derived
    grad_clip: float = 0.0  # >0: clip gradients by global norm
    grad_accum: int = 1  # >1: accumulate N micro-steps per optimizer update
    # (total_steps/warmup_steps count micro-steps; the schedule counts
    # updates)
    no_ddp: bool = False  # single process even when a coordinator is given
    model_name: Optional[str] = None  # default per task (resnet50 /
    # bert_base / gpt_base)
    image_size: int = 224
    seq_len: int = 128
    vocab_size: Optional[int] = None  # None = the model's own default
    pretrained: Optional[str] = None  # path to a torch.save'd torchvision
    # ResNet state_dict: backbone weights and BN statistics import into the
    # model (models/pretrained.py); the head stays fresh unless its shape
    # matches. Classification/ResNet only.
    prefetch: int = 2
    producer_threads: int = 4  # decode-producer threads; with the placement
    # plane off (global_batch=False) they also place each batch
    global_batch: bool = True  # route every loader through the placement
    # plane (data/placement.py): a dedicated thread copies each host batch
    # to the card on a side stream and keeps placement_depth batches ahead
    # of the step. False = the synchronous control arm (make_global_batch on
    # the consumer thread, on the compute stream; bit-identical batches)
    placement_depth: int = 2  # placed batches the ring keeps ahead
    buffer_pool: bool = True  # decode into recycled pages of the process
    # BufferPool (page-locked on CUDA); False = a fresh allocation per batch
    shuffle: bool = False  # epoch batch-order reshuffle (batch sampler and
    # the iterable folder arm; the map-style loader always reshuffles rows)
    augment: bool = True  # per-image horizontal flip, p = 0.5 (classification)
    eval_at_end: bool = True  # process 0 evaluates every row of the eval
    # data once after training: the val split, else the train pool, else
    # the val dataset (make_eval_pipeline; text: the padded arm)
    eval_every: int = 0  # >0: eval every N epochs (val_acc in the history)
    seed: int = 0
    log_every: int = 50
    log_grad_norm: bool = False  # the micro-batch gradient's global norm in
    # the progress lines (under grad_accum the update clips the mean)
    run_name: Optional[str] = None  # default
    # DP-<loader_style>-<sampler>-<model>
    no_wandb: bool = False  # the port has no wandb sink; recorded only
    checkpoint_dir: Optional[str] = None  # resumes from the newest intact
    # checkpoint there, when one exists
    checkpoint_every: int = 1  # save every N epochs
    checkpoint_every_steps: int = 0  # >0: also every N micro-steps, with
    # the cursor (absolute steps across restarts)
    resume: bool = True  # restore the newest checkpoint if one exists
    profile_dir: Optional[str] = None  # torch.profiler trace of early steps
    flash_attention: bool = False  # the hand-written CUDA flash kernels
    seq_parallelism: int = 1  # masked_lm: ring attention over N sequence
    # blocks (K5), in this process or across N processes a ring
    device_decode: bool = False  # classification: the host stops at the
    # JPEG entropy boundary and K2 decodes the coefficient pages on the device
    token_pack: bool = False  # text tasks: ragged pages + FFD plan on the
    # host, K3 packs them into [rows, pack_len] grids on the device
    pack_len: int = 0  # packed slot-length cap; 0 = seq_len
    pack_rows_multiple: int = 8  # packed row-count rounding quantum
    device: str = "cuda"  # cuda | cpu: where the model and the step run
    coordinator_address: Optional[str] = None  # host:port of process 0
    num_processes: Optional[int] = None  # world size
    process_id: Optional[int] = None  # this process's rank


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) → a CUDA device, raising when no card is
    available; ``"cpu"`` → the CPU. Never falls back silently."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run on the CPU"
            )
        return device
    if device.type == "cpu":
        return device
    raise ValueError(f"unsupported device {name!r} (cuda | cpu)")


# -------------------------------------------------------------- schedules


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def fn(count: int) -> float:
        frac = min(max(count, 0), steps) / steps
        return init + (end - init) * frac
    return fn


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    def fn(count: int) -> float:
        frac = min(max(count, 0), steps) / steps
        return init * 0.5 * (1.0 + math.cos(math.pi * frac))
    return fn


def lr_schedule_fn(config: TrainConfig,
                   total_steps: Optional[int] = None
                   ) -> Union[float, Callable[[int], float]]:
    """A float (constant) or a function of the number of optimizer updates
    done so far — optax's ``linear_schedule``, ``cosine_decay_schedule`` and
    ``warmup_cosine_decay_schedule`` as the JAX trainer uses them. The
    horizon and the warmup count micro-steps; under ``grad_accum`` they
    become updates by ceiling division, as the JAX trainer converts them."""
    horizon = total_steps or config.total_steps
    accum = max(config.grad_accum, 1)
    if config.lr_schedule == "constant":
        if config.warmup_steps > 0:
            return _linear(0.0, config.lr,
                           max(-(-config.warmup_steps // accum), 1))
        return config.lr
    if config.lr_schedule == "cosine":
        if not horizon:
            raise ValueError("cosine schedule needs total_steps")
        horizon = max(-(-horizon // accum), 1)
        warmup = -(-config.warmup_steps // accum)
        if warmup > 0:
            decay_steps = max(horizon, warmup + 1)
            warm = _linear(0.0, config.lr, warmup)
            decay = _cosine(config.lr, decay_steps - warmup)
            return lambda count: (
                warm(count) if count < warmup else decay(count - warmup)
            )
        return _cosine(config.lr, horizon)
    raise ValueError(f"Invalid lr_schedule: {config.lr_schedule}")


def make_optimizer(config: TrainConfig, params,
                   total_steps: Optional[int] = None):
    """``(optimizer, lr)``: SGD with momentum (``dampening=0`` and L2 decay
    on the gradient, which is optax's ``add_decayed_weights`` + ``sgd``
    trace) or AdamW (decoupled decay, as ``optax.adamw``). ``lr`` is what
    :func:`lr_schedule_fn` returns; the train step applies it per update."""
    lr = lr_schedule_fn(config, total_steps)
    lr0 = lr(0) if callable(lr) else lr
    params = list(params)
    if config.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=config.momentum,
                              dampening=0.0,
                              weight_decay=config.weight_decay)
    elif config.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=config.weight_decay)
    else:
        raise ValueError(f"Invalid optimizer: {config.optimizer}")
    return opt, lr


def _global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all the tensors together, as an
    f32 device scalar."""
    norms = torch._foreach_norm(tensors)
    return torch.linalg.vector_norm(torch.stack([n.float() for n in norms]))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale gradients in place by ``max_norm / norm`` when their global
    norm exceeds ``max_norm`` (``optax.clip_by_global_norm``); returns the
    norm as a device scalar, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = _global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class TrainStep:
    """``step(batch, generator=None, mlm_mask=None, flip_mask=None) ->
    loss``: one micro-step — forward, backward and, every ``grad_accum``
    micro-steps, optional clipping and one optimizer update. The task's
    random draw (masked-LM: ``mlm_mask``, classification: ``flip_mask``) is
    given or made from ``generator``. ``lr`` is what :func:`make_optimizer`
    returned: a schedule sets each update's rate from the updates done so
    far, a float leaves the optimizer's own. The returned loss is the
    pre-update loss, detached and still on the device. BatchNorm's running
    statistics update in every micro-step's forward, as the JAX step
    replaces them every step.

    ``grad_accum = k > 1`` keeps ``optax.MultiSteps``' semantics: each
    backward writes a fresh ``.grad`` (so ``grad_norm`` reads the
    micro-batch's own gradient, ``optax.global_norm`` of the JAX step's
    ``grads``), which is folded into one accumulator buffer a parameter as
    the running mean ``acc + (g - acc) / (n + 1)`` — one ``lerp`` with
    weight ``1 / (n + 1)``, within an ulp of optax's division. The
    parameters and the optimizer's state do not change inside a window; on
    the k-th micro-step the optimizer steps once on the mean (clipping and
    SGD's L2 decay act on it, as the JAX chain does inside MultiSteps), and
    the accumulator is zeroed. A partial window is never applied. Under DDP
    every micro-step's backward all-reduces, as the JAX step's gradient
    mean does, so the norm is the global batch's. ``fold_times`` (a
    :class:`_DeviceTimes`) times each fold on the card.

    :meth:`state_dict` / :meth:`load_state_dict` carry the accumulator, its
    micro-step count and the update count through a checkpoint."""

    def __init__(self, task: Task, optimizer: torch.optim.Optimizer,
                 lr: Union[float, Callable[[int], float], None] = None,
                 grad_clip: float = 0.0, grad_accum: int = 1,
                 grad_norm: bool = False, fold_times=None):
        self.task = task
        self.optimizer = optimizer
        self.lr = lr
        self.grad_clip = grad_clip
        self.grad_accum = max(int(grad_accum), 1)
        self.grad_norm = grad_norm
        self.fold_times = fold_times or _DeviceTimes(False)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.updates = 0
        self.micro_step = 0  # micro-steps folded into the open window
        self.accum = None
        if self.grad_accum > 1:
            self.accum = [torch.zeros_like(p) for p in self.params]
        self.last_grad_norm: Optional[torch.Tensor] = None

    def _fold(self, grads) -> None:
        torch._foreach_lerp_(self.accum, grads, 1.0 / (self.micro_step + 1))

    def __call__(self, batch, generator=None, mlm_mask=None, flip_mask=None):
        self.optimizer.zero_grad(set_to_none=True)
        draws = {name: value for name, value in
                 (("mlm_mask", mlm_mask), ("flip_mask", flip_mask))
                 if value is not None}
        outputs = self.task.forward(batch, True, generator, **draws)
        loss = self.task.loss(outputs, batch)
        # The outputs (a text model's [B, S, vocab] f32 logits) are not
        # needed by the backward: dropping them here lowers its peak.
        del outputs
        loss.backward()
        if self.grad_norm:
            self.last_grad_norm = _global_norm(
                [p.grad for p in self.params if p.grad is not None])
        if self.accum is not None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
            self.fold_times.run(self._fold, grads)
            self.micro_step += 1
            if self.micro_step < self.grad_accum:
                return loss.detach()
            self.micro_step = 0
            for p, acc in zip(self.params, self.accum):
                p.grad = acc
        if self.grad_clip > 0:
            clip_by_global_norm_(self.params, self.grad_clip)
        if callable(self.lr):
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(self.updates)
        self.optimizer.step()
        self.updates += 1
        if self.accum is not None:
            self.optimizer.zero_grad(set_to_none=True)
            torch._foreach_zero_(self.accum)
        return loss.detach()

    def state_dict(self) -> dict:
        return {"grad_accum": self.grad_accum, "updates": self.updates,
                "micro_step": self.micro_step, "accum": self.accum}

    def load_state_dict(self, state: dict) -> None:
        if int(state["grad_accum"]) != self.grad_accum:
            raise ValueError(
                f"checkpoint was taken with grad_accum {state['grad_accum']}"
                f", this run has {self.grad_accum}")
        self.updates = int(state["updates"])
        self.micro_step = int(state["micro_step"])
        if self.accum is not None:
            with torch.no_grad():
                for acc, saved in zip(self.accum, state["accum"]):
                    acc.copy_(saved)


def make_train_step(task: Task, optimizer: torch.optim.Optimizer,
                    lr: Union[float, Callable[[int], float], None] = None,
                    grad_clip: float = 0.0, grad_accum: int = 1,
                    grad_norm: bool = False, fold_times=None) -> TrainStep:
    """The train step (:class:`TrainStep`) of ``task`` under
    ``optimizer``."""
    return TrainStep(task, optimizer, lr, grad_clip, grad_accum, grad_norm,
                     fold_times)


def make_eval_step(task: Task):
    """``step(batch) -> (metric_sum, example_count)``, both device
    scalars. A batch carrying ``_weight`` (the eval loader's pad mask)
    contributes ``(metric·w).sum(), w.sum()``, so wrap-around pad rows count
    zero; otherwise the count is the batch size."""

    def step(batch):
        batch = dict(batch)
        w = batch.pop("_weight", None)
        with torch.no_grad():
            m = task.metric(task.forward(batch, False), batch).float()
        if w is None:
            return m.sum(), torch.tensor(float(m.shape[0]), device=m.device)
        w = w.to(device=m.device, dtype=torch.float32)
        return (m * w).sum(), w.sum()

    return step


def evaluate(loader, eval_step) -> tuple[float, float]:
    """``(mean metric, weighted example count)`` over a loader. The
    per-batch sums accumulate on the device; the only host sync is the
    fetch at the end. The loader's iterator is closed on every path, so
    that its threads end with the eval."""
    num = den = None
    it = iter(loader)
    try:
        for batch in it:
            part, count = eval_step(batch)
            num = part if num is None else num + part
            den = count if den is None else den + count
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if den is None:
        return 0.0, 0.0
    total = float(den)
    return (float(num) / total if total else 0.0), total


class _DeviceTimes:
    """CUDA event pairs around one piece of device work per step, read at
    log points (:meth:`drain`), so timing adds no host sync of its own. On
    the CPU nothing is timed."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._events: list[tuple] = []
        self.ms: list[float] = []

    def run(self, fn, *args):
        if not self.cuda:
            return fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self._events.append((start, end))
        return out

    def drain(self) -> list[float]:
        """The times recorded since the last drain, in ms."""
        new = []
        for start, end in self._events:
            end.synchronize()
            new.append(start.elapsed_time(end))
        self._events.clear()
        self.ms.extend(new)
        return new


def _mean(values) -> Optional[float]:
    return statistics.fmean(values) if values else None


class _StepLog:
    """Per-step losses (device scalars) and, on the card, per-step CUDA
    event pairs; :meth:`drain` fetches them in one sync at a log point.
    Across processes the drained losses are the global batch's: each
    process's local mean, averaged over the group."""

    def __init__(self, cuda: bool, world: int = 1):
        self.cuda = cuda
        self.world = world
        self._losses: list[torch.Tensor] = []
        self._events: list[tuple] = []
        self.losses: list[float] = []
        self.step_ms: list[float] = []

    def start(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, start, loss: torch.Tensor) -> None:
        self._losses.append(loss)
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((start, end))

    def drain(self) -> None:
        if self._losses:
            losses = torch.stack(self._losses).float()
            if self.world > 1:
                dist.all_reduce(losses)
                losses /= self.world
            self.losses.extend(losses.tolist())
            self._losses.clear()
        for start, end in self._events:
            end.synchronize()
            self.step_ms.append(start.elapsed_time(end))
        self._events.clear()


def train(config: TrainConfig) -> dict:
    """Train ``config.task_type`` on ``config.dataset_path``.

    Returns ``{"steps", "epochs", "losses", "step_ms", "device", …}``:
    ``losses`` holds every step's loss (the global batch's) and, on the
    card, ``step_ms`` every step's time between CUDA events around it;
    classification adds ``images_per_sec`` (the images of the steps after
    the first log point over their wall time, loader waits included, closed
    by a device sync; the whole loop when there is no later step),
    ``images_per_sec_whole_run`` (every image over the whole loop, warm-up
    included) and ``decoder_arm``; with ``eval_at_end`` every task adds
    ``eval_accuracy`` and ``eval_rows``; with ``device_decode`` also
    ``decode_entropy_ms`` (median host time of a batch's entropy decode,
    over the train loop), ``decode_threads`` and, on the card,
    ``decode_device_ms`` (median K2 time of a train batch). Text tasks add
    ``tokens_per_sec`` (grid tokens of the steps after the first log point
    over their wall time), ``valid_tokens_per_sec`` (their payload tokens
    over the same time), ``pad_waste_pct`` (100·(1 − payload/grid) over the
    same steps), ``grid_tokens`` and ``payload_tokens`` (each step's), the
    decoder's ``pack_*`` counters (every batch it decoded) and,
    with ``token_pack``, ``pack_device_ms`` (median K3 time, on the card)
    and ``pack_new_shapes_total``. ``eval_accuracy`` is the task's metric
    (next-token or masked-token accuracy for text), over the eval rows: the
    ``val_fraction`` split, else the train pool (every row, or the
    ``filter`` pool), else the ``val_dataset_path`` rows (its own filter
    pool). ``model`` and
    ``optimizer`` are the trained module and its optimizer.

    ``steps`` counts this run's micro-steps and ``global_step`` the
    absolute ones across restarts; ``start_epoch`` is the epoch this run
    began in and ``preempted`` is True after a drain (the eval at the end
    is then skipped). With ``eval_every`` each ``history`` entry of such an
    epoch adds ``val_acc`` and ``val_rows``. With ``checkpoint_dir``:
    ``ckpt_save_ms`` (each save's time on the training thread),
    ``ckpt_write_ms`` (each file write on the writer thread),
    ``ckpt_last_success_step``, ``ckpt_restore_ms`` (None without a
    restore) and ``ckpt_bytes`` (the newest state file's size). Under
    ``grad_accum``, ``accum_fold_ms`` is the median fold time on the card
    (None on the CPU);
    with ``profile_dir``, ``profile_trace`` names the trace file. Every run
    adds ``bufpool_hits``, ``bufpool_misses`` and ``bufpool_miss_ms`` (the
    pool's leases during the run, and the time spent allocating the missed
    pages; 0 without ``buffer_pool``) and, with ``global_batch``,
    ``placement_ms`` (each train batch's time on the placement thread, its
    copies' completion included) and ``h2d_pct`` (the placement time of the
    progress windows after the first log point over their loader-plus-step
    time, as ``images_per_sec`` leaves the warm-up out; the whole loop when
    there is no later window)."""
    _check_loader_config(config)
    if config.placement_depth < 1:
        raise ValueError(
            f"placement_depth must be >= 1, got {config.placement_depth}"
        )
    if config.pretrained and config.task_type != "classification":
        raise ValueError(
            "--pretrained imports torchvision ResNet checkpoints; task "
            f"{config.task_type!r} has no importer"
        )
    if config.task_type not in PORTED_TASKS:
        raise NotImplementedError(
            f"task_type {config.task_type!r} is not yet ported "
            f"(ported: {', '.join(PORTED_TASKS)})"
        )
    if config.device_decode and config.task_type != "classification":
        raise ValueError(
            "device_decode splits the JPEG decode loop and currently "
            f"supports task_type='classification' only, got "
            f"{config.task_type!r}"
        )
    if config.token_pack:
        if config.task_type not in _TEXT_TASKS:
            raise ValueError(
                "token_pack packs token columns and needs a text task "
                f"({'/'.join(_TEXT_TASKS)}), got {config.task_type!r}"
            )
        if config.seq_parallelism > 1:
            raise ValueError(
                "token_pack is incompatible with seq_parallelism/"
                "pipeline_parallelism: packed batches re-enter the data "
                "layout inside the pack transform and carry no static "
                "sequence split"
            )
        if (config.num_processes or 1) > 1:
            raise ValueError(
                "token_pack currently supports single-process training "
                "only: each process's packed row count is data-dependent, "
                "and multi-host global-batch assembly needs identical "
                "per-process shapes"
            )
    _check_seq_parallelism(config)
    if (config.device_decode and (config.num_processes or 1) > 1
            and not config.no_ddp):
        import warnings

        # Each process's decoder grows its page grid to its own shard's
        # largest image. The port assembles no global batch, so unequal
        # grids do not fail as they do in the JAX trainer, but on a
        # mixed-size corpus the processes decode pages of different sizes
        # and the slowest sets every step's pace.
        warnings.warn(
            "device_decode with multi-process local decode: each process "
            "grows its coefficient grid to its own shard's largest image, "
            "so on a mixed-size corpus the processes decode unequal pages "
            "and the slowest paces every step; such corpora should stream "
            "pixels (--no_device_decode)",
            stacklevel=2,
        )
    device = resolve_device(config.device)
    if not config.no_ddp:
        maybe_initialize_distributed(config.coordinator_address,
                                     config.num_processes, config.process_id,
                                     device)
    try:
        return _train(config, device)
    finally:
        shutdown_distributed()


def _check_loader_config(config: TrainConfig) -> None:
    """The JAX trainer's refusals of a loader combination, with its
    messages, before any dataset I/O."""
    if config.val_fraction:
        if not 0.0 < config.val_fraction < 1.0:
            raise ValueError(
                f"val_fraction must be in (0, 1), got {config.val_fraction}"
            )
        if config.val_dataset_path:
            raise ValueError(
                "val_fraction and val_dataset_path are mutually exclusive"
            )
        if config.data_format != "columnar" or config.loader_style != "map":
            raise ValueError(
                "val_fraction needs the map-style columnar path (the split "
                "is an index pool); pass loader_style='map'"
            )
    if config.filter and config.data_format != "columnar":
        raise ValueError("filter= needs the columnar store (data_format="
                         "'columnar'); folder trees have no row predicates")
    if config.filter and config.loader_style != "map":
        raise ValueError(
            "filter= needs the map-style loader (the predicate resolves to "
            "an index pool; iterable range plans read contiguous rows); pass "
            "loader_style='map'"
        )


def _split_val_pool(config: TrainConfig, dataset: Dataset,
                    index_pool: Optional[np.ndarray]):
    """The held-out validation fraction: a seeded disjoint split of the
    (possibly filtered) row pool, the same on every process. Returns
    ``(train_pool, val_pool)``, both sorted global row indices."""
    pool = (index_pool if index_pool is not None
            else np.arange(dataset.count_rows(), dtype=np.int64))
    if len(pool) < 2 * config.batch_size:
        # Both sides need at least one full global batch (this also guards
        # an empty filter pool).
        raise ValueError(
            f"val_fraction needs at least two global batches "
            f"(2×{config.batch_size}) in the pool; have {len(pool)} rows"
        )
    n_val = int(len(pool) * config.val_fraction)
    if n_val < config.batch_size:
        warnings.warn(
            f"val_fraction {config.val_fraction} yields {n_val} rows — "
            f"raised to one global batch ({config.batch_size} rows = "
            f"{config.batch_size / len(pool):.1%} of the pool)",
            stacklevel=3,
        )
        n_val = config.batch_size
    if len(pool) - n_val < config.batch_size:
        raise ValueError(
            f"val_fraction {config.val_fraction} leaves fewer than one "
            f"global batch ({config.batch_size}) on one side of the "
            f"split ({len(pool)} rows available)"
        )
    perm = np.random.default_rng(config.seed).permutation(len(pool))
    return np.sort(pool[perm[n_val:]]), np.sort(pool[perm[:n_val]])


def _loader_buffer_pool(config: TrainConfig):
    """The process :class:`~.data.buffers.BufferPool` when the knob is on
    (its page-locked one when the run is on a card), shared by the decoders
    (the lease side) and every loader and placement (the release side)."""
    if not config.buffer_pool:
        return None
    cuda = torch.device(config.device).type == "cuda"
    return default_buffer_pool(pin_memory=cuda)


def _make_placement(config: TrainConfig, device: torch.device):
    """The :class:`~.data.placement.PlacementPlane` of one loader, or
    ``None`` for the synchronous control arm (``global_batch=False``)."""
    if not config.global_batch:
        return None
    return PlacementPlane(device, depth=config.placement_depth,
                          buffer_pool=_loader_buffer_pool(config))


def _loader_kwargs(config: TrainConfig, device: torch.device, plane) -> dict:
    """Where a loader places its batches (nowhere behind a plane: it
    yields host batches), its producers and its pool."""
    return dict(device=None if plane is not None else device,
                producers=config.producer_threads,
                buffer_pool=_loader_buffer_pool(config))


def _build_loader(config: TrainConfig, dataset: Optional[Dataset], decode,
                  device: torch.device, epoch: int, per_process: int,
                  data_index: int, data_world: int,
                  index_pool: Optional[np.ndarray] = None):
    """This epoch's train loader: the iterable range plans, the map-style
    loader over the run's pool, or the folder arm in either style, with
    the JAX trainer's refusals of an empty plan and of a folder with more
    classes than ``num_classes``; wrapped in the placement plane unless the
    synchronous arm is chosen."""
    plane = _make_placement(config, device)
    kw = _loader_kwargs(config, device, plane)
    if config.data_format == "folder":
        loader = FolderDataPipeline(
            config.dataset_path, per_process, data_index, data_world, decode,
            loader_style=config.loader_style,
            # Map-style always reshuffles (DistributedSampler semantics);
            # the iterable arm's batch-order shuffle is opt-in, as on the
            # columnar iterable path.
            shuffle=True if config.loader_style == "map" else config.shuffle,
            seed=config.seed, epoch=epoch, prefetch=config.prefetch, **kw)
        if len(loader) == 0:
            raise ValueError("folder smaller than one global batch")
        if (config.task_type == "classification"
                and loader.num_classes > config.num_classes):
            raise ValueError(
                f"folder has {loader.num_classes} class directories but "
                f"num_classes={config.num_classes}; out-of-range labels "
                "would be silently clamped by the XLA gather"
            )
        return plane.wrap(loader) if plane is not None else loader
    if config.loader_style == "map":
        if index_pool is not None and len(index_pool) < config.batch_size:
            raise ValueError(
                f"filter {config.filter!r} keeps {len(index_pool)} rows — "
                f"fewer than one global batch ({config.batch_size})"
            )
        loader = make_map_style_pipeline(
            dataset, per_process, data_index, data_world, decode,
            seed=config.seed, epoch=epoch, prefetch=config.prefetch,
            columns=getattr(decode, "required_columns", None),
            index_pool=index_pool, **kw)
        if len(loader) == 0:
            raise ValueError(
                "empty plan: dataset smaller than one global batch "
                f"({dataset.count_rows()} rows, global batch "
                f"{config.batch_size})"
            )
    else:
        loader = make_train_pipeline(
            dataset, config.sampler_type, per_process, data_index,
            data_world, decode, prefetch=config.prefetch,
            shuffle=config.shuffle, seed=config.seed, epoch=epoch, **kw)
    return plane.wrap(loader) if plane is not None else loader


def _check_seq_parallelism(config: TrainConfig) -> None:
    """The JAX trainer's refusals of an attention path it cannot take
    (``_task_from_config``), with its messages."""
    if config.flash_attention and config.seq_parallelism > 1:
        raise ValueError(
            "flash_attention cannot combine with seq_parallelism or "
            "pipeline_parallelism (they select their own attention path)"
        )
    if config.seq_parallelism > 1:
        if config.task_type != "masked_lm":
            raise ValueError(
                "seq_parallelism>1 requires a sequence model (masked_lm)"
            )
        if config.seq_len % config.seq_parallelism:
            raise ValueError(
                f"seq_len {config.seq_len} not divisible by "
                f"seq_parallelism {config.seq_parallelism}"
            )


def _share_seed(seed: int, data_index: int) -> int:
    """The MLM mask generator's seed for data share ``data_index``: share 0
    keeps ``seed + 1``, the others draw apart (an odd stride modulo 2^32:
    the CPU generator reads only a seed's low 32 bits)."""
    return (seed + 1 + data_index * 0x9E3779B1) % 2 ** 32


def _sequence_block(batch: dict, mlm_mask: torch.Tensor, index: int,
                    parts: int):
    """Block ``index`` of ``parts`` along the sequence of a padded text
    batch and of its MLM mask, with the block's global ``position_ids``."""
    rows, length = batch["input_ids"].shape
    size = length // parts
    lo, hi = index * size, (index + 1) * size
    block = {key: value[:, lo:hi]
             if value.dim() == 2 and value.shape[1] == length else value
             for key, value in batch.items()}
    block["position_ids"] = torch.arange(
        lo, hi, device=batch["input_ids"].device).expand(rows, size)
    return block, mlm_mask[:, lo:hi]


def _token_pack_config(config: TrainConfig):
    """The run's :class:`~.data.token_pack.TokenPackConfig`, or ``None``
    when packing is off."""
    if not config.token_pack:
        return None
    return TokenPackConfig(pack_len=config.pack_len or config.seq_len,
                           rows_multiple=config.pack_rows_multiple)


def _decoder_for(config: TrainConfig, for_eval: bool = False):
    """The decode hook of the run's train (or eval) loader, leasing its
    pages from the run's pool. The eval always streams the padded arm:
    per-row metrics and the eval loader's ``_weight`` pads need one
    sequence a row."""
    pool = _loader_buffer_pool(config)
    if config.task_type == "classification":
        return decoder_for_task("classification",
                                image_size=config.image_size,
                                device_decode=config.device_decode,
                                buffer_pool=pool)
    return decoder_for_task(
        config.task_type, seq_len=config.seq_len,
        token_pack=None if for_eval else _token_pack_config(config),
        buffer_pool=pool)


class _TokenCounts:
    """Each text step's grid cells and payload tokens. A packed batch gives
    both in its host header (``rows × pack_len`` and the plan's payload); a
    padded batch its ``input_ids`` grid and its attention mask's count,
    taken on the device and read at the next log point's sync."""

    def __init__(self):
        self.grid: list[int] = []
        self.payload: list[int] = []
        self._pending: list = []  # (step index, device count)

    def add(self, batch) -> None:
        if is_ragged_batch(batch):
            rows, pack_len, payload, _mode = pack_meta(batch)
            self.grid.append(rows * pack_len)
            self.payload.append(payload)
            return
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        self.grid.append(int(ids.numel()))
        if mask is None:
            self.payload.append(int(ids.numel()))
            return
        self._pending.append((len(self.payload), torch.count_nonzero(mask)))
        self.payload.append(0)

    def read(self) -> None:
        """Fill in the device counts taken since the last read."""
        if not self._pending:
            return
        index, counts = zip(*self._pending)
        for i, count in zip(index, torch.stack(counts).tolist()):
            self.payload[i] = int(count)
        self._pending.clear()

    def rates(self, steps: int, seconds: float) -> dict:
        """Grid and valid tokens/s of the last ``steps`` steps over
        ``seconds``, and their ``pad_waste_pct`` = 100·(1 − payload/grid)."""
        self.read()
        first = len(self.grid) - steps
        grid, payload = sum(self.grid[first:]), sum(self.payload[first:])
        per_s = 1.0 / seconds if seconds > 0 else 0.0
        return {"tokens_per_sec": grid * per_s,
                "valid_tokens_per_sec": payload * per_s,
                "pad_waste_pct": 100.0 * (1.0 - payload / grid)
                if grid else 0.0}


class _CkptJournal:
    """Checkpoint bookkeeping shared between the step loop and the
    emergency save. Updated only at completed-step boundaries, so the live
    train state pairs with the cursor naming the exact next batch whenever
    ``at_boundary`` holds; a step that raises midway leaves it False, and
    no state is saved that pairs a half-done step with a cursor."""

    def __init__(self, resume_global_step: int = 0):
        self.cursor_base: Optional[dict] = None  # loader {"epoch","step"}
        self.abs_step = resume_global_step  # absolute completed micro-steps
        self.saved_step = resume_global_step  # newest persisted abs_step
        self.at_boundary = True
        self.preempted = False

    @property
    def dirty(self) -> bool:
        return self.cursor_base is not None and self.abs_step > self.saved_step


def _save_checkpoint(ckpt: CheckpointManager, journal: _CkptJournal,
                     model, optimizer, train_step, mask_gen, rank: int,
                     world: int, wait: bool = False) -> None:
    """Every process's mask generator state, gathered to rank 0, goes into
    the cursor; rank 0 writes the pair (the replicas are equal); every rank
    passes a barrier after the save."""
    states = [pack_rng_key(mask_gen)]
    if world > 1:
        states = [None] * world
        dist.all_gather_object(states, pack_rng_key(mask_gen))
    if rank == 0:
        cursor = dict(journal.cursor_base)
        cursor.update(global_step=journal.abs_step, rng=states)
        ckpt.save(journal.abs_step,
                  {"model": model.state_dict(),
                   "optimizer": optimizer.state_dict(),
                   "train_step": train_step.state_dict()},
                  cursor=cursor, wait=wait)
    sync_global_devices()
    # An intact duplicate (save returned False) holds this step as well.
    journal.saved_step = journal.abs_step


def _restore_checkpoint(ckpt: CheckpointManager, model, optimizer,
                        train_step, mask_gen, rank: int, world: int,
                        epochs: int):
    """Restore the newest intact checkpoint into the live objects:
    ``(start_epoch, epoch_step, global_step)``, or ``None`` when there is
    none. Resuming under a different world size raises."""
    restored = ckpt.restore_latest()
    if restored is None:
        return None
    state, cursor, step = restored
    rngs = cursor.get("rng") or []
    if len(rngs) != world:
        raise ValueError(
            f"checkpoint step {step} was taken by {len(rngs)} processes; "
            f"this run has {world}")
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    train_step.load_state_dict(state["train_step"])
    unpack_rng_key(rngs[rank], mask_gen)
    start_epoch = min(int(cursor.get("epoch", 0)), epochs)
    epoch_step = int(cursor.get("step", 0)) if start_epoch < epochs else 0
    return start_epoch, epoch_step, int(cursor.get("global_step", step))


def _train(config: TrainConfig, device: torch.device) -> dict:
    rank, world = process_topology()
    if config.no_ddp:
        rank, world = 0, 1
    if device.type == "cuda":
        if device.index is None:
            index = (rank % torch.cuda.device_count() if world > 1
                     else torch.cuda.current_device())
            device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    cuda = device.type == "cuda"
    sp = config.seq_parallelism
    # The data share this process reads: its rank's, or with a process ring
    # its data index's, which the ring's members share.
    data_index, data_world, seq_index = rank, world, 0
    ring = None
    if sp > 1 and world > 1:
        data_index, data_world, seq_index = seq_topology(rank, world, sp)
        ring = ProcessRing(*new_seq_groups(sp))
    per_process, rem = divmod(config.batch_size, data_world)
    if rem:
        raise ValueError(f"global batch {config.batch_size} not divisible by "
                         f"{data_world} processes")
    image = config.task_type == "classification"
    folder = config.data_format == "folder"
    dataset = None if folder else Dataset(config.dataset_path)
    # The folder arm evaluates its own tree: a val dataset is columnar.
    val_dataset = (Dataset(config.val_dataset_path)
                   if config.val_dataset_path and not folder else None)
    init_gen = torch.Generator().manual_seed(config.seed)
    attention_fn = None
    if image:
        if cuda:
            torch.backends.cudnn.benchmark = True  # conv autotuning, as XLA
        task = get_task("classification", num_classes=config.num_classes,
                        model_name=config.model_name,
                        image_size=config.image_size, augment=config.augment,
                        device=device, generator=init_gen)
    else:
        if sp > 1:
            attention_fn = make_ring_attention(sp, ring)
        elif config.flash_attention:
            # causal_lm binds the kernels' causal mask.
            attention_fn = make_flash_attention(
                causal=config.task_type == "causal_lm")
        task = get_task(config.task_type, model_name=config.model_name,
                        seq_len=config.seq_len, vocab_size=config.vocab_size,
                        attention_fn=attention_fn, device=device,
                        generator=init_gen,
                        loss_group=dist.group.WORLD if world > 1 else None)
    if config.pretrained:
        # Transfer learning, the reference's training task: the backbone
        # (and a head of the same shape) from the checkpoint, before the
        # DDP wrap (every rank loads the same weights) and before a
        # restore (a resumed run takes the checkpoint's weights).
        load_torchvision_resnet(task.model,
                                load_torch_state_dict(config.pretrained),
                                config.model_name or "resnet50")
    decode = _decoder_for(config)
    train_task = task
    if world > 1:
        set_sync_group(task.model, dist.group.WORLD)
        ddp = DistributedDataParallel(
            task.model, device_ids=[device.index] if cuda else None,
            broadcast_buffers=False)
        train_task = task.with_model(ddp)
    # Classification draws one flip per image of the global batch and each
    # process slices it; masked-LM draws per data share.
    mask_gen = torch.Generator(device=device).manual_seed(
        config.seed + 1 if image else _share_seed(config.seed, data_index))

    # The row pools, resolved once a run (deterministic, so every process
    # derives the same) and passed to every epoch's loader: the filter's
    # (map-style columnar only, as _check_loader_config holds), then the
    # val split inside it.
    index_pool = val_pool = None
    if config.filter:
        index_pool = dataset.filter_indices(config.filter)
    if config.val_fraction > 0:
        index_pool, val_pool = _split_val_pool(config, dataset, index_pool)
    samples = _folder_samples(config.dataset_path)[0] if folder else None
    total_steps = config.total_steps
    if total_steps is None and config.lr_schedule != "constant":
        # Steps an epoch times epochs; a filter pool or a val split
        # shortens the horizon with it.
        rows = (len(index_pool) if index_pool is not None
                else len(samples) if folder else dataset.count_rows())
        total_steps = max(rows // config.batch_size, 1) * config.epochs
    optimizer, lr = make_optimizer(config, task.model.parameters(),
                                   total_steps)
    accum = max(config.grad_accum, 1)
    fold_times = _DeviceTimes(cuda)
    step = make_train_step(train_task, optimizer, lr, config.grad_clip,
                           grad_accum=accum, grad_norm=config.log_grad_norm,
                           fold_times=fold_times)

    # Checkpoint/resume: the newest INTACT step restores the model, the
    # optimizer, the accumulator and the generators together with the
    # data-plane cursor (epoch, batches consumed, absolute step), so the
    # resumed stream — and with it the loss trajectory — is the
    # uninterrupted run's.
    ckpt = CheckpointManager(config.checkpoint_dir) \
        if config.checkpoint_dir else None
    start_epoch = resume_epoch_step = resume_global_step = 0
    restore_ms = None
    if ckpt is not None and config.resume:
        t0 = time.perf_counter()
        resumed = _restore_checkpoint(ckpt, task.model, optimizer, step,
                                      mask_gen, rank, world, config.epochs)
        if resumed is not None:
            start_epoch, resume_epoch_step, resume_global_step = resumed
            if cuda:
                torch.cuda.synchronize(device)
            restore_ms = (time.perf_counter() - t0) * 1e3

    logger = MetricLogger(
        active=rank == 0,
        run_name=config.run_name or f"DP-{config.loader_style}-"
                                    f"{config.sampler_type}-"
                                    f"{config.model_name or task.name}",
        config=dataclasses.asdict(config), enabled=not config.no_wandb)
    timer = StepTimer()
    log = _StepLog(cuda, world)
    coeff = config.device_decode
    # The device stage between the H2D copy and the step: K2 on coefficient
    # pages, or K3 on ragged token pages; its CUDA-event times are read at
    # log points under ``device_ms_key``.
    transform, device_ms_key = None, None
    if coeff:
        transform = make_batch_transform(config.image_size)
        device_ms_key = "decode_device_ms"
    elif config.token_pack:
        transform = make_pack_transform()
        device_ms_key = "pack_device_ms"
    transform_times = _DeviceTimes(cuda)
    tokens = _TokenCounts()  # text: grid and payload tokens of each step
    entropy_seen = 0  # decode.entropy_ms entries already logged
    if image:
        logger.log({"decoder_arm": decode.arm})

    # The eval's rows, in the JAX trainer's order of precedence: the val
    # split, then the train pool when there is no val dataset, then a val
    # dataset, which resolves its own filter pool (at its first eval).
    eval_dataset = val_dataset if val_dataset is not None else dataset
    eval_pool = (val_pool if val_pool is not None
                 else index_pool if val_dataset is None else None)

    def run_eval():
        """Rank 0 evaluates every row (or pool position) of the eval data
        once; ``(accuracy, rows)`` there, ``None`` elsewhere, after a
        barrier."""
        nonlocal eval_pool
        out = None
        if rank == 0:
            eval_decode = decode if image else _decoder_for(config,
                                                            for_eval=True)
            if folder:
                def read_fn(idx):
                    return read_sample_batch(samples, idx)
                total = len(samples)
            else:
                columns = decode.required_columns if image else None

                def read_fn(idx):
                    return eval_dataset.take(idx, columns=columns)
                total = eval_dataset.count_rows()
                if config.filter and eval_pool is None:
                    eval_pool = eval_dataset.filter_indices(config.filter)
            plane = _make_placement(config, device)
            loader = make_eval_pipeline(
                read_fn, total, config.batch_size, 0, 1, eval_decode,
                prefetch=config.prefetch, index_pool=eval_pool,
                **_loader_kwargs(config, device, plane))
            if plane is not None:
                loader = plane.wrap(loader)
            eval_step = make_eval_step(task)
            if coeff:
                eval_step = (lambda b, _step=eval_step: _step(transform(b)))
            # Rank 0 folds whole sequences in its process: the other ranks
            # do not join a ring during the eval.
            with (attention_fn.whole_sequence() if ring is not None
                  else contextlib.nullcontext()):
                out = evaluate(loader, eval_step)
        sync_global_devices()
        return out

    # Parse the chaos spec BEFORE installing the handler: a malformed
    # LDT_CHAOS raises, and must not leave SIGTERM hijacked behind it.
    chaos = TrainerChaos.from_env()
    trace = StepTrace.from_env() if rank == 0 else None
    preempt = PreemptionHandler().install()
    if chaos is not None:
        chaos.drain_cb = preempt.request
    journal = _CkptJournal(resume_global_step)
    profile = (ProfileWindow(config.profile_dir, cuda)
               if config.profile_dir and rank == 0 else None)

    def save(wait: bool = False) -> None:
        _save_checkpoint(ckpt, journal, task.model, optimizer, step,
                         mask_gen, rank, world, wait=wait)

    pool = _loader_buffer_pool(config)
    pool_start = pool.counters() if pool is not None else None
    placement_ms: list[float] = []  # each train batch's placement
    h2d_windows: list[tuple] = []  # (placement s, loader + step s) a window
    global_step = 0  # this run's micro-steps
    stop = False
    history = []
    lo, hi = rank * per_process, (rank + 1) * per_process
    t_start = time.perf_counter()
    warm = None  # (steps, time) at the first log point: warm-up ends there
    try:
        for epoch in range(start_epoch, config.epochs):
            loader = _build_loader(config, dataset, decode, device, epoch,
                                   per_process, data_index, data_world,
                                   index_pool)
            if epoch == start_epoch and resume_epoch_step:
                # The rebuilt plan is a pure function of (pool, shard,
                # seed, epoch): the tail it serves from the cursor is what
                # the uninterrupted run consumed.
                loader.load_state_dict({"epoch": epoch,
                                        "step": resume_epoch_step})
            epoch_steps = 0
            # The plane's placement_* windows ride the progress lines.
            timer.attach_counters(getattr(loader, "placement_counters", None))
            it = iter(loader)
            try:
                while not stop:
                    timer.loader_start()
                    batch = next(it, None)
                    timer.loader_stop()
                    if batch is None:
                        break
                    if profile is not None and epoch == start_epoch:
                        profile.at(epoch_steps)
                    journal.at_boundary = False
                    timer.step_start()
                    start = log.start()
                    fed = batch  # the loader's batch, for the step trace
                    if not image:
                        tokens.add(batch)
                    if transform is not None:
                        batch = transform_times.run(transform, batch)
                    if image and config.augment:
                        # One draw over the global batch, sliced per
                        # process: the flips do not depend on the world size.
                        draw = torch.rand(config.batch_size, generator=mask_gen,
                                          device=device) < 0.5
                        loss = step(batch, flip_mask=draw[lo:hi])
                    elif ring is not None:
                        # The ring's members draw alike over the whole rows
                        # and each trains on its sequence block.
                        block, drawn = _sequence_block(
                            batch, draw_mlm_mask(batch, mask_gen), seq_index,
                            sp)
                        loss = step(block, mlm_mask=drawn)
                    else:
                        loss = step(batch, mask_gen)
                    log.stop(start, loss)
                    timer.step_stop()
                    epoch_steps += 1
                    global_step += 1
                    # Step boundary: the live state pairs with the cursor
                    # naming the NEXT batch (batches handed out so far).
                    journal.abs_step = resume_global_step + global_step
                    journal.cursor_base = loader.state_dict()
                    journal.at_boundary = True
                    if trace is not None:
                        trace.record(journal.abs_step, epoch, fed, loss)
                    if 0 < config.max_steps <= global_step:
                        stop = True
                    if config.log_every and global_step % config.log_every == 0:
                        log.drain()  # the one host sync of this window
                        if warm is None:
                            warm = (global_step, time.perf_counter())
                        w = timer.window(config.batch_size, images=image)
                        if image:
                            rates = {"images_per_sec": w["images_per_sec"]}
                        else:
                            rates = tokens.rates(w["steps"], w["wall_s"])
                        extra = {}
                        if transform is not None:
                            extra[device_ms_key] = _mean(
                                transform_times.drain())
                        if coeff:
                            # The decoder's batches since the last log (its
                            # producer thread may run ahead of the steps).
                            seen = len(decode.entropy_ms)
                            extra["decode_entropy_ms"] = _mean(
                                decode.entropy_ms[entropy_seen:seen])
                            entropy_seen = seen
                        # Schedules count optimizer updates, not
                        # micro-steps; the restored step count carries the
                        # position across a resume.
                        updates = journal.abs_step // accum
                        extra["lr"] = float(lr(updates) if callable(lr)
                                            else lr)
                        if config.log_grad_norm:
                            extra["grad_norm"] = round(
                                float(step.last_grad_norm), 4)
                        if accum > 1:
                            fold_times.drain()
                        extra = {k: v for k, v in extra.items()
                                 if v is not None}
                        busy = w["loader_s"] + w["step_s"]
                        if "placement_h2d_s" in w:
                            # Placement time of the window (on its own
                            # thread, beside the step) as a share of the
                            # same loader-plus-step time.
                            extra["h2d_pct"] = (
                                100.0 * w["placement_h2d_s"] / busy
                                if busy > 0 else 0.0)
                            h2d_windows.append((w["placement_h2d_s"], busy))
                            extra["placement_buffer_depth"] = int(
                                w.get("placement_buffer_depth", 0))
                        logger.log({
                            "step": global_step,
                            "epoch": epoch,
                            "loss": round(log.losses[-1], 4),
                            "step_ms": w["step_ms"],
                            **rates,
                            "loader_stall_pct": (
                                100.0 * w["loader_s"] / busy
                                if busy > 0 else 0.0
                            ),
                            **extra,
                        })
                    if (ckpt is not None and config.checkpoint_every_steps > 0
                            and journal.abs_step >= journal.saved_step
                            + config.checkpoint_every_steps):
                        # ">= saved + N" rather than "% N", as the JAX loop.
                        save()
                    if chaos is not None:
                        chaos.on_step(global_step)
                    if preempt.requested and not stop:
                        # The in-flight step has finished; the awaited
                        # emergency checkpoint follows the loop.
                        journal.preempted = True
                        logger.log({"preempted": True,
                                    "at_step": journal.abs_step,
                                    "epoch": epoch})
                        stop = True
            finally:
                it.close()
                timer.attach_counters()
            plane = getattr(loader, "plane", None)
            if plane is not None:
                placement_ms.extend(plane.h2d_ms)
            if profile is not None:
                profile.stop()  # an epoch shorter than the trace window
            if epoch_steps:
                log.drain()
                mean = statistics.fmean(log.losses[-epoch_steps:])
                entry = {"epoch": epoch, "train_loss": mean}
                if config.eval_every and (epoch + 1) % config.eval_every == 0:
                    evaluated = run_eval()
                    if evaluated is not None:
                        entry.update(val_acc=evaluated[0],
                                     val_rows=evaluated[1])
                history.append(entry)
                logger.log({**entry, "steps": global_step})
            if (ckpt is not None and (epoch + 1) % config.checkpoint_every == 0
                    and not stop):
                # Epoch-boundary checkpoint with a cursor naming the next
                # epoch's first batch. A max_steps stop mid-epoch must not
                # checkpoint the partial epoch as completed (preemption
                # goes through the emergency save instead).
                journal.cursor_base = {"epoch": epoch + 1, "step": 0}
                save()
            if stop:
                break
        if journal.preempted and ckpt is not None and journal.dirty:
            save(wait=True)  # the awaited emergency checkpoint
        log.drain()
        t_end = time.perf_counter()
        train_time = t_end - t_start
        results = {}
        if transform is not None:
            transform_times.drain()
            results[device_ms_key] = (statistics.median(transform_times.ms)
                                      if transform_times.ms else None)
        if coeff:
            results.update(
                decode_entropy_ms=statistics.median(decode.entropy_ms)
                if decode.entropy_ms else None,
                decode_threads=decode.threads)
        if config.token_pack:
            results["pack_new_shapes_total"] = transform.pack_new_shapes_total
        if config.eval_at_end and not journal.preempted:
            evaluated = run_eval()
            if evaluated is not None:
                evaluated = {"eval_accuracy": evaluated[0],
                             "eval_rows": evaluated[1]}
                results.update(evaluated)
                logger.log(evaluated)
        if ckpt is not None:
            ckpt.close()
    except BaseException:
        if ckpt is not None:
            try:
                # A crashed run persists its last completed step, awaited,
                # when the live state sits at a step boundary. Across
                # processes the peers may never reach the save's
                # collectives, so only a lone process saves here.
                if journal.dirty and journal.at_boundary and world == 1:
                    save(wait=True)
                ckpt.close()
            except Exception:  # noqa: BLE001 — never mask the run's error
                pass
        raise
    finally:
        try:
            if profile is not None:
                profile.stop()
        finally:
            preempt.uninstall()
            if trace is not None:
                trace.close()
            logger.close()
    timed_steps, timed_s = global_step, train_time
    if warm is not None and global_step > warm[0]:
        timed_steps, timed_s = global_step - warm[0], t_end - warm[1]
    if not image:
        results.update(
            tokens.rates(timed_steps, timed_s), grid_tokens=tokens.grid,
            payload_tokens=tokens.payload, **decode.counters())
    if image:
        results.update(
            images_per_sec=config.batch_size * timed_steps / timed_s,
            images_per_sec_whole_run=config.batch_size * global_step
            / train_time,
            decoder_arm=decode.arm)
    if journal.preempted:
        results["preempted"] = True
    if ckpt is not None:
        newest = ckpt.latest_step()
        results.update(
            ckpt_save_ms=ckpt.save_ms, ckpt_write_ms=ckpt.write_ms,
            ckpt_last_success_step=ckpt.last_success_step,
            ckpt_restore_ms=restore_ms,
            ckpt_bytes=(os.path.getsize(ckpt.state_path(newest))
                        if newest is not None else None))
    if pool is not None:
        end = pool.counters()
        results.update(bufpool_hits=end["hits"] - pool_start["hits"],
                       bufpool_misses=end["misses"] - pool_start["misses"],
                       bufpool_miss_ms=end["miss_ms"] - pool_start["miss_ms"])
    else:
        results.update(bufpool_hits=0, bufpool_misses=0, bufpool_miss_ms=0.0)
    if config.global_batch:
        windows = h2d_windows[1:] or [(sum(placement_ms) / 1e3,
                                       timer.loader_s + timer.step_s)]
        h2d_s, busy = map(sum, zip(*windows))
        results.update(placement_ms=placement_ms,
                       h2d_pct=100.0 * h2d_s / busy if busy > 0 else 0.0)
    if accum > 1:
        fold_times.drain()
        results["accum_fold_ms"] = (statistics.median(fold_times.ms)
                                    if fold_times.ms else None)
    if profile is not None:
        results["profile_trace"] = profile.path
    return {
        "steps": global_step,
        "global_step": journal.abs_step,
        "start_epoch": start_epoch,
        "epochs": len(history),
        "history": history,
        "losses": log.losses,
        "step_ms": log.step_ms,
        "loader_stall_pct": timer.loader_stall_pct,
        "train_time": train_time,
        "total_time": time.perf_counter() - t_start,
        "device": str(device),
        "world_size": world,
        "model_params": sum(p.numel() for p in task.model.parameters()),
        "model": task.model,
        "optimizer": optimizer,
        **results,
    }
