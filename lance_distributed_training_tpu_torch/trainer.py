"""The trainer: one ``train()`` over a pluggable input pipeline and task.

Counterpart of ``lance_distributed_training_tpu/trainer.py`` for image
classification (ResNet) and masked-LM text: ``TrainConfig`` (the subset of
the JAX flags these paths use, plus ``device``), the learning-rate
schedules, the optimizers (SGD with momentum, AdamW, global-norm clipping),
the train step, the weighted eval (``make_eval_step``, ``evaluate``) and the
loop. The loss stays on the device: per-step losses are fetched only at log
points and at the end, never with a per-step ``.item()``.

Device decode (``device_decode``, classification only): the loader ships
JPEG coefficient pages (``data/device_decode.py``) and K2
(``ops/jpeg_device.py``) turns them into the uint8 batch on the device,
after the H2D copy and before the step, for the train and the eval
batches alike; its device time is read from CUDA events at log points.

Data parallelism: with ``coordinator_address``/``num_processes``/
``process_id`` each process joins a ``torch.distributed`` group, owns one
device, reads ``batch_size / world`` rows of each global batch through the
samplers' rank arguments, and trains a DDP replica whose BatchNorm takes
the global batch's statistics, as the JAX step does over its sharded batch.

The device is the caller's choice: ``device="cuda"`` (the default) raises
when no card is present rather than falling back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .data.decode import decoder_for_task
from .data.format import Dataset
from .data.pipeline import make_eval_pipeline, make_train_pipeline
from .models.resnet import set_sync_group
from .models.tasks import Task, get_task
from .ops.flash import make_flash_attention
from .ops.jpeg_device import make_batch_transform
from .parallel.mesh import (
    maybe_initialize_distributed,
    process_topology,
    shutdown_distributed,
    sync_global_devices,
)
from .utils.metrics import MetricLogger, StepTimer

__all__ = [
    "TrainConfig",
    "train",
    "resolve_device",
    "lr_schedule_fn",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "evaluate",
    "clip_by_global_norm_",
]

PORTED_TASKS = ("classification", "masked_lm")


@dataclasses.dataclass
class TrainConfig:
    """The JAX trainer's flags that the ported paths use, plus ``device``."""

    dataset_path: str
    task_type: str = "classification"
    num_classes: int = 101
    sampler_type: str = "batch"  # batch | fragment | full
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
    no_ddp: bool = False  # single process even when a coordinator is given
    model_name: Optional[str] = None  # default per task (resnet50 / bert_base)
    image_size: int = 224
    seq_len: int = 128
    vocab_size: Optional[int] = None  # None = the model's own default
    prefetch: int = 2
    shuffle: bool = False  # epoch batch-order reshuffle (batch sampler)
    augment: bool = True  # per-image horizontal flip, p = 0.5 (classification)
    eval_at_end: bool = True  # classification: process 0 evaluates every
    # row of the train data once after training (make_eval_pipeline)
    seed: int = 0
    log_every: int = 50
    flash_attention: bool = False  # the hand-written CUDA flash kernels
    device_decode: bool = False  # classification: the host stops at the
    # JPEG entropy boundary and K2 decodes the coefficient pages on the device
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
    ``warmup_cosine_decay_schedule`` as the JAX trainer uses them."""
    horizon = total_steps or config.total_steps
    if config.lr_schedule == "constant":
        if config.warmup_steps > 0:
            return _linear(0.0, config.lr, max(config.warmup_steps, 1))
        return config.lr
    if config.lr_schedule == "cosine":
        if not horizon:
            raise ValueError("cosine schedule needs total_steps")
        warmup = config.warmup_steps
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


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale gradients in place by ``max_norm / norm`` when their global
    norm exceeds ``max_norm`` (``optax.clip_by_global_norm``); returns the
    norm as a device scalar, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def make_train_step(task: Task, optimizer: torch.optim.Optimizer,
                    lr: Union[float, Callable[[int], float], None] = None,
                    grad_clip: float = 0.0):
    """``step(batch, generator=None, mlm_mask=None, flip_mask=None) ->
    loss``: forward, backward, optional clipping and one optimizer update.
    The task's random draw (masked-LM: ``mlm_mask``, classification:
    ``flip_mask``) is given or made from ``generator``. ``lr`` is what
    :func:`make_optimizer` returned: a schedule sets each update's rate, a
    float leaves the optimizer's own. The returned loss is the pre-update
    loss, detached and still on the device. BatchNorm's running statistics
    update in the forward."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    updates = 0

    def step(batch, generator=None, mlm_mask=None, flip_mask=None):
        nonlocal updates
        if callable(lr):
            for group in optimizer.param_groups:
                group["lr"] = lr(updates)
        optimizer.zero_grad(set_to_none=True)
        draws = {name: value for name, value in
                 (("mlm_mask", mlm_mask), ("flip_mask", flip_mask))
                 if value is not None}
        outputs = task.forward(batch, True, generator, **draws)
        loss = task.loss(outputs, batch)
        loss.backward()
        if grad_clip > 0:
            clip_by_global_norm_(params, grad_clip)
        optimizer.step()
        updates += 1
        return loss.detach()

    return step


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
    fetch at the end."""
    num = den = None
    for batch in loader:
        part, count = eval_step(batch)
        num = part if num is None else num + part
        den = count if den is None else den + count
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
    included), ``decoder_arm`` and, with ``eval_at_end``,
    ``eval_accuracy`` and ``eval_rows``; with ``device_decode`` also
    ``decode_entropy_ms`` (median host time of a batch's entropy decode,
    over the train loop), ``decode_threads`` and, on the card,
    ``decode_device_ms`` (median K2 time of a train batch). ``model`` is the
    trained module."""
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
    per_process, rem = divmod(config.batch_size, world)
    if rem:
        raise ValueError(f"global batch {config.batch_size} not divisible by "
                         f"{world} processes")
    image = config.task_type == "classification"
    dataset = Dataset(config.dataset_path)
    init_gen = torch.Generator().manual_seed(config.seed)
    if image:
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # conv autotuning, as XLA
        task = get_task("classification", num_classes=config.num_classes,
                        model_name=config.model_name,
                        image_size=config.image_size, augment=config.augment,
                        device=device, generator=init_gen)
        decode = decoder_for_task("classification",
                                  image_size=config.image_size,
                                  device_decode=config.device_decode)
    else:
        attention_fn = (make_flash_attention() if config.flash_attention
                        else None)
        task = get_task(config.task_type, model_name=config.model_name,
                        seq_len=config.seq_len, vocab_size=config.vocab_size,
                        attention_fn=attention_fn, device=device,
                        generator=init_gen)
        decode = decoder_for_task(config.task_type, seq_len=config.seq_len)
    train_task = task
    if world > 1:
        set_sync_group(task.model, dist.group.WORLD)
        ddp = DistributedDataParallel(
            task.model, device_ids=[device.index] if device.type == "cuda"
            else None, broadcast_buffers=False)
        train_task = task.with_model(ddp)
    mask_gen = torch.Generator(device=device).manual_seed(config.seed + 1)

    total_steps = config.total_steps
    if total_steps is None and config.lr_schedule != "constant":
        total_steps = (max(dataset.count_rows() // config.batch_size, 1)
                       * config.epochs)
    optimizer, lr = make_optimizer(config, task.model.parameters(),
                                   total_steps)
    step = make_train_step(train_task, optimizer, lr, config.grad_clip)

    logger = MetricLogger(active=rank == 0)
    timer = StepTimer()
    log = _StepLog(device.type == "cuda", world)
    coeff = config.device_decode
    transform = make_batch_transform(config.image_size) if coeff else None
    k2_times = _DeviceTimes(device.type == "cuda")
    entropy_seen = 0  # decode.entropy_ms entries already logged
    if image:
        logger.log({"decoder_arm": decode.arm})
    global_step = 0
    stop = False
    history = []
    lo, hi = rank * per_process, (rank + 1) * per_process
    t_start = time.perf_counter()
    warm = None  # (steps, time) at the first log point: warm-up ends there
    try:
        for epoch in range(config.epochs):
            loader = make_train_pipeline(
                dataset, config.sampler_type, per_process, rank, world,
                decode, device, prefetch=config.prefetch,
                shuffle=config.shuffle, seed=config.seed, epoch=epoch,
            )
            epoch_steps = 0
            it = iter(loader)
            try:
                while not stop:
                    timer.loader_start()
                    batch = next(it, None)
                    timer.loader_stop()
                    if batch is None:
                        break
                    timer.step_start()
                    start = log.start()
                    if transform is not None:
                        batch = k2_times.run(transform, batch)
                    if image and config.augment:
                        # One draw over the global batch, sliced per
                        # process: the flips do not depend on the world size.
                        draw = torch.rand(config.batch_size, generator=mask_gen,
                                          device=device) < 0.5
                        loss = step(batch, flip_mask=draw[lo:hi])
                    else:
                        loss = step(batch, mask_gen)
                    log.stop(start, loss)
                    timer.step_stop()
                    epoch_steps += 1
                    global_step += 1
                    if 0 < config.max_steps <= global_step:
                        stop = True
                    if config.log_every and global_step % config.log_every == 0:
                        log.drain()  # the one host sync of this window
                        if warm is None:
                            warm = (global_step, time.perf_counter())
                        w = timer.window(config.batch_size,
                                         None if image else config.seq_len,
                                         images=image)
                        rate = "images_per_sec" if image else "tokens_per_sec"
                        extra = {}
                        if coeff:
                            # The decoder's batches since the last log (its
                            # producer thread may run ahead of the steps).
                            seen = len(decode.entropy_ms)
                            extra = {
                                "decode_entropy_ms": _mean(
                                    decode.entropy_ms[entropy_seen:seen]),
                                "decode_device_ms": _mean(k2_times.drain()),
                            }
                            extra = {k: v for k, v in extra.items()
                                     if v is not None}
                            entropy_seen = seen
                        logger.log({
                            "step": global_step,
                            "epoch": epoch,
                            "loss": round(log.losses[-1], 4),
                            "step_ms": w["step_ms"],
                            rate: w[rate],
                            "loader_stall_pct": (
                                100.0 * w["loader_s"]
                                / (w["loader_s"] + w["step_s"])
                                if w["loader_s"] + w["step_s"] > 0 else 0.0
                            ),
                            **extra,
                        })
            finally:
                it.close()
            if epoch_steps:
                log.drain()
                mean = statistics.fmean(log.losses[-epoch_steps:])
                history.append({"epoch": epoch, "train_loss": mean})
                logger.log({"epoch": epoch, "train_loss": mean,
                            "steps": global_step})
            if stop:
                break
        log.drain()
        t_end = time.perf_counter()
        train_time = t_end - t_start
        results = {}
        if coeff:
            k2_times.drain()
            results = {
                "decode_entropy_ms": statistics.median(decode.entropy_ms)
                if decode.entropy_ms else None,
                "decode_device_ms": statistics.median(k2_times.ms)
                if k2_times.ms else None,
                "decode_threads": decode.threads,
            }
        if image and config.eval_at_end:
            if rank == 0:
                columns = decode.required_columns
                loader = make_eval_pipeline(
                    lambda idx: dataset.take(idx, columns=columns),
                    dataset.count_rows(), config.batch_size, 0, 1, decode,
                    device, prefetch=config.prefetch)
                eval_step = make_eval_step(task)
                if transform is not None:
                    eval_step = (lambda b, _step=eval_step:
                                 _step(transform(b)))
                acc, rows = evaluate(loader, eval_step)
                evaluated = {"eval_accuracy": acc, "eval_rows": rows}
                results.update(evaluated)
                logger.log(evaluated)
            sync_global_devices()
    finally:
        logger.close()
    if image:
        timed_steps, timed_s = global_step, train_time
        if warm is not None and global_step > warm[0]:
            timed_steps, timed_s = global_step - warm[0], t_end - warm[1]
        results.update(
            images_per_sec=config.batch_size * timed_steps / timed_s,
            images_per_sec_whole_run=config.batch_size * global_step
            / train_time,
            decoder_arm=decode.arm)
    return {
        "steps": global_step,
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
        **results,
    }
