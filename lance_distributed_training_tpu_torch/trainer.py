"""The trainer: one ``train()`` over a pluggable input pipeline and task.

Counterpart of ``lance_distributed_training_tpu/trainer.py`` for image
classification (ResNet, ViT), masked-LM and causal-LM text (switch-MoE
blocks with ``num_experts``) and CLIP contrastive image-caption training:
``TrainConfig``
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

Token packing (``token_pack``, text tasks; for contrastive the captions
are bucketed, one a row, so each stays beside its image): the loader
ships ragged token pages and a first-fit-decreasing plan
(``data/token_pack.py``), and K3
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
A text loss is the global batch's weighted mean (``models/tasks.py``);
MoE layers route over the global batch and the contrastive loss takes
every process's embeddings (``models/moe.py``, ``models/clip.py``).

Sequence parallelism (``seq_parallelism``, masked-LM): attention runs as a
ring over ``seq_parallelism`` sequence blocks (``parallel/
ring_attention.py``, K5). One process holds every ring position on its
device. Across processes the ranks form JAX's ``('data', 'seq')`` mesh,
data outermost: the members of one ring read the same rows (sampler rank =
data index), share one MLM mask draw (seeded by the data index), and each
trains on its sequence block with its global ``position_ids``, the key and
value blocks passing between them; DDP spans the world. The eval runs on
the ring too: each member folds its block of the rows under the whole
rows' eval mask.

Beyond DP, as the JAX trainer (``model_parallelism``, ``fsdp``,
``zero_opt`` 1/2, ``pipeline_parallelism`` with ``pp_microbatches``, and
``num_experts`` under the model axis or on a ring of processes): the ranks
form JAX's ``(data, model, seq, pipe)`` mesh (``parallel/comm.Topology``),
a rank reads its data index's share, the plan of ``parallel/sharding.py``
lays out the whole model built alike on every rank, and the sharded state
of ``parallel/layout.py`` replaces DDP; under ``fsdp`` it gathers the
parameters block by block (encoder, ResNet and ViT blocks) in the forward
and again in the backward. The eval runs on every rank, DDP included,
under the run's layout, as JAX's sharded eval step: each data share reads
its slice of every global eval batch (the ranks of one model group, ring
or pipeline the same slice) and the ``(sum, count)`` pairs are summed over
the data shares, so that every rank returns the whole eval's accuracy. A
checkpoint is sharded: every rank writes its own blocks (each replicated
leaf once, by the lowest rank that holds it) and a resume reads this
rank's blocks under the run's layout, whatever layout saved the step.

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

The worker pool, the cache plane and the autotuner, at the JAX trainer's
defaults: ``num_workers > 0`` decodes in that many spawned processes
(``data/workers.py``; shared-memory slots unless ``shm_workers`` is off),
one pool a run; ``batch_cache`` keeps decoded host batches in a RAM/disk
cache (``data/cache.BatchCache``, one a run, outliving the per-epoch
loaders) so that later epochs and restarted runs skip read and decode;
``device_cache`` keeps the first streamed epoch's batches on the card,
after the transform stage, and replays them in later epochs in a seeded
batch order (``DeviceReplayCache``); ``data_echo`` runs N optimizer steps
a host batch, each with a fresh draw of the flips or the MLM mask. The
closed-loop autotuner (``autotune``, on by default; ``tune/``) reads the
metrics registry every ``autotune_interval_s`` and moves the knobs of the
epoch's loader, the pool, the buffer pool and the cache; replay epochs
register none. The tuner stops before the pool shuts down, the pool before
the cache closes.

The remote arm, as the JAX trainer's: with ``data_service_addr`` (one
``serve-data`` server) or ``coordinator_addr`` (a fleet behind a
coordinator; ``job_id``/``job_priority`` name the run's job there) decode
runs in those host processes and this process only receives the batches,
equal to local decode's bit for bit, and places them; the dataset need be
readable here only for the eval and the schedule horizon.
``metrics_port`` serves ``/metrics`` and ``/healthz`` for the run
(``obs/http.py``) with the SLO tracker's burn rates.

The device is the caller's choice: ``device="cuda"`` (the default) raises
when no card is present rather than falling back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
import warnings
from datetime import timedelta
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .data.buffers import default_buffer_pool
from .data.cache import BatchCache, DeviceReplayCache, folder_fingerprint
from .data.decode import decoder_for_task
from .data.authoring import _folder_samples
from .data.folder import read_sample_batch
from .data.format import Dataset
from .data.graph import (Buffers, Cache, Decode, DevicePut, EvalSource,
                         FleetTransport, FolderSource, InProcess, LanceSource,
                         LoaderGraph, MapStyleSource, Place, Pool, Prefetch,
                         ServiceTransport)
from .data.placement import PlacementPlane
from .data.pipeline import refuse_empty_plan
from .data.token_pack import TokenPackConfig, is_ragged_batch, pack_meta
from .models.pretrained import load_torch_state_dict, load_torchvision_resnet
from .obs.registry import default_registry
from .models.resnet import set_sync_group
from .models.tasks import Task, draw_mlm_mask, eval_mlm_mask, get_task
from .ops.flash import make_flash_attention
from .ops.jpeg_device import make_batch_transform
from .ops.token_device import make_pack_transform
from .parallel.mesh import (
    maybe_initialize_distributed,
    process_topology,
    shutdown_distributed,
)
from .parallel.comm import Topology, all_reduce, transport_name
from .parallel.layout import ShardedState, shard_model_
from .parallel.ring_attention import ProcessRing, make_ring_attention
from .parallel.sharding import plan_bytes, plan_model, rules_for_task
from .models.convert import flax_named_shapes
from .models.moe import set_moe_group
from .tune import AutoTuner, collect_tunables
from .utils import compiletrack
from .utils.chaos import StepTrace, TrainerChaos, batch_digest
from .utils.checkpoint import (CheckpointManager, CheckpointRefused,
                               pack_rng_key, unpack_rng_key)
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

PORTED_TASKS = ("classification", "masked_lm", "causal_lm", "contrastive")
_TEXT_TASKS = ("masked_lm", "causal_lm", "contrastive")
_IMAGE_TASKS = ("classification", "contrastive")


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
    # bert_base / gpt_base / clip_resnet50_bert)
    image_size: int = 224
    seq_len: int = 128  # text tasks and contrastive captions
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
    num_workers: int = 0  # >0: read and decode in that many spawned worker
    # processes (data/workers.py), one pool a run
    shm_workers: bool = True  # worker batches cross through shared-memory
    # slots; False = pickled (the control arm)
    autotune: bool = True  # the closed-loop autotuner (tune/) moves the
    # live knobs of the loaders, the pool and the caches (capacity only,
    # but pack_len re-plans packed batches); False = fixed knobs
    autotune_interval_s: float = 1.0  # the tuner's tick period
    data_echo: int = 1  # >1: N optimizer steps a host batch, each with a
    # fresh draw of the flips / MLM mask (the schedule horizon counts them)
    device_cache: bool = False  # keep the first streamed epoch's batches on
    # the card (after the transform stage) and replay them afterwards in a
    # seeded batch order
    device_cache_gb: float = 8.0  # projected-size guard: stream instead
    # when the epoch would not fit (clamped to 90% of the card's free memory)
    batch_cache: bool = False  # the decoded-batch cache (RAM, then disk;
    # content-keyed, so the stream is bit-identical to the uncached run)
    cache_ram_budget_mb: int = 512  # the cache's RAM budget
    cache_disk_budget_mb: int = 2048  # the cache's disk budget
    cache_dir: Optional[str] = None  # spill directory; default
    # ~/.cache/lance_distributed_training_tpu_torch/batch-cache
    shuffle: bool = False  # epoch batch-order reshuffle (batch sampler and
    # the iterable folder arm; the map-style loader always reshuffles rows)
    augment: bool = True  # per-image horizontal flip, p = 0.5 (image tasks)
    eval_at_end: bool = True  # every row of the eval data once after
    # training, split over the data shares: the val split, else the train
    # pool, else the val dataset (make_eval_pipeline; text: the padded arm)
    eval_every: int = 0  # >0: eval every N epochs (val_acc in the history)
    seed: int = 0
    log_every: int = 50
    metrics_port: Optional[int] = None  # process 0 serves /metrics
    # (Prometheus text: trainer_*, svc_* and lineage_* series) and /healthz
    # for the run; None = off, 0 = an ephemeral port (in the progress log)
    metrics_host: str = "127.0.0.1"  # the exporter's bind address
    # (non-loopback is an explicit opt-in: the endpoint has no auth)
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
    remat: bool = False  # rematerialize transformer blocks (long-context)
    num_experts: int = 0  # >0: switch-MoE blocks (masked_lm, causal_lm)
    moe_every: int = 2  # MoE on every Nth block
    seq_parallelism: int = 1  # masked_lm: ring attention over N sequence
    # blocks (K5), in this process or across N processes a ring
    # -- parallelism beyond DP (parallel/sharding.py, parallel/layout.py) --
    model_parallelism: int = 1  # tensor-parallel degree ('model' mesh axis)
    pipeline_parallelism: int = 1  # GPipe stages over a 'pipe' mesh axis
    pp_microbatches: int = 4  # microbatches per pipeline round
    fsdp: bool = False  # ZeRO-3-style: fully shard params + optimizer state
    # over the 'data' axis (each large leaf's largest divisible dimension)
    zero_opt: int = 0  # ZeRO over the 'data' axis, params replicated. 1:
    # shard the optimizer moments only; 2: also the gradient accumulator
    # (grad_accum), the step's gradients reduce-scattered into it.
    # Mutually exclusive with fsdp (which already shards both)
    device_decode: bool = False  # classification: the host stops at the
    # JPEG entropy boundary and K2 decodes the coefficient pages on the device
    token_pack: bool = False  # text tasks: ragged pages + FFD plan on the
    # host, K3 packs them into [rows, pack_len] grids on the device
    pack_len: int = 0  # packed slot-length cap; 0 = seq_len
    pack_rows_multiple: int = 8  # packed row-count rounding quantum
    data_service_addr: Optional[str] = None  # host:port of a running
    # `serve-data` DataService: decode runs there and this process streams
    # the plan-ordered batches (service/client.RemoteLoader), identical to
    # local training's on the same seed. Iterable columnar path only; the
    # decode knobs must match the server's.
    coordinator_addr: Optional[str] = None  # host:port of a running
    # `coordinator`: the FleetLoader stripes this shard's plan over its
    # members and restripes at the cursor when one is lost (same batches).
    # Exclusive with data_service_addr; not the torch.distributed
    # rendezvous (coordinator_address)
    job_id: Optional[str] = None  # this run's job on a shared service or
    # fleet: its resume cursor, fair share and admission there. None = the
    # implicit default job
    job_priority: Optional[str] = None  # inference | training | bulk for
    # job_id; None = the server's default (training)
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


def clip_by_global_norm_(params, max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale gradients in place by ``max_norm / norm`` when their global
    norm exceeds ``max_norm`` (``optax.clip_by_global_norm``); returns the
    norm as a device scalar, without a host sync. ``norm`` is the global
    norm when the gradients are blocks of a sharded state."""
    grads = [p.grad for p in params if p.grad is not None]
    if norm is None:
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
    micro-step count and the update count through a checkpoint.

    Under a layout beyond DP, ``sharded`` (a
    :class:`~.parallel.layout.ShardedState`) replaces DDP: it gathers the
    parameters a step needs, averages each micro-step's gradients over the
    batch group into the accumulator's layout, hands each master (what the
    optimizer updates) its gradient, takes the global norm over the
    groups, and after the update spreads the updated blocks."""

    def __init__(self, task: Task, optimizer: torch.optim.Optimizer,
                 lr: Union[float, Callable[[int], float], None] = None,
                 grad_clip: float = 0.0, grad_accum: int = 1,
                 grad_norm: bool = False, fold_times=None, sharded=None):
        self.task = task
        self.optimizer = optimizer
        self.lr = lr
        self.grad_clip = grad_clip
        self.grad_accum = max(int(grad_accum), 1)
        self.grad_norm = grad_norm
        self.fold_times = fold_times or _DeviceTimes(False)
        self.sharded = sharded
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.updates = 0
        self.micro_step = 0  # micro-steps folded into the open window
        self.accum = None
        if self.grad_accum > 1:
            self.accum = (sharded.new_accum() if sharded is not None else
                          [torch.zeros_like(p) for p in self.params])
        self.last_grad_norm: Optional[torch.Tensor] = None

    def _fold(self, grads) -> None:
        torch._foreach_lerp_(self.accum, grads, 1.0 / (self.micro_step + 1))

    def __call__(self, batch, generator=None, mlm_mask=None, flip_mask=None):
        self.optimizer.zero_grad(set_to_none=True)
        sharded = self.sharded
        if sharded is not None:
            sharded.gather_params()
        draws = {name: value for name, value in
                 (("mlm_mask", mlm_mask), ("flip_mask", flip_mask))
                 if value is not None}
        if compiletrack.enabled():
            compiletrack.track_forward(self.task.model, batch, **draws)
        outputs = self.task.forward(batch, True, generator, **draws)
        loss = self.task.loss(outputs, batch)
        # The outputs (a text model's [B, S, vocab] f32 logits) are not
        # needed by the backward: dropping them here lowers its peak.
        del outputs
        loss.backward()
        if sharded is not None:
            grads = sharded.reduce_grads()
            if self.grad_norm:
                self.last_grad_norm = sharded.global_norm(grads)
        else:
            if self.grad_norm:
                self.last_grad_norm = _global_norm(
                    [p.grad for p in self.params if p.grad is not None])
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
        layouts = "reduce"
        if self.accum is not None:
            self.fold_times.run(self._fold, grads)
            self.micro_step += 1
            if self.micro_step < self.grad_accum:
                return loss.detach()
            self.micro_step = 0
            grads, layouts = self.accum, "accum"
            if sharded is None:
                for p, acc in zip(self.params, self.accum):
                    p.grad = acc
        if sharded is not None:
            sharded.set_master_grads(grads, layouts)
        if self.grad_clip > 0:
            clip_by_global_norm_(
                self.params, self.grad_clip,
                norm=(sharded.global_norm([p.grad for p in self.params],
                                          "master")
                      if sharded is not None else None))
        if callable(self.lr):
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(self.updates)
        self.optimizer.step()
        self.updates += 1
        if sharded is not None:
            sharded.after_update()
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
        if self.accum is not None and state["accum"] is not None:
            with torch.no_grad():
                for acc, saved in zip(self.accum, state["accum"]):
                    acc.copy_(saved)


def make_train_step(task: Task, optimizer: torch.optim.Optimizer,
                    lr: Union[float, Callable[[int], float], None] = None,
                    grad_clip: float = 0.0, grad_accum: int = 1,
                    grad_norm: bool = False, fold_times=None,
                    sharded=None) -> TrainStep:
    """The train step (:class:`TrainStep`) of ``task`` under
    ``optimizer``."""
    return TrainStep(task, optimizer, lr, grad_clip, grad_accum, grad_norm,
                     fold_times, sharded)


def make_eval_step(task: Task, seq: Optional[tuple] = None):
    """``step(batch) -> (metric_sum, example_count)``, both device
    scalars. A batch carrying ``_weight`` (the eval loader's pad mask)
    contributes ``(metric·w).sum(), w.sum()``, so wrap-around pad rows count
    zero; otherwise the count is the batch size. ``seq = (index, parts,
    group)`` evaluates on a ring of processes, as training does there:
    this rank's sequence block of the rows, under the whole rows' eval
    mask, with the masked-LM metric's per-row sums taken over the ring."""

    def step(batch):
        if compiletrack.enabled():
            compiletrack.track_launch(batch)
        batch = dict(batch)
        w = batch.pop("_weight", None)
        with torch.no_grad():
            if seq is None:
                m = task.metric(task.forward(batch, False), batch)
            else:
                index, parts, group = seq
                block, mask = _sequence_block(batch, eval_mlm_mask(batch),
                                              index, parts)
                m = task.metric(task.forward(block, False, mlm_mask=mask),
                                block, seq_group=group)
            m = m.float()
        if w is None:
            return m.sum(), torch.tensor(float(m.shape[0]), device=m.device)
        w = w.to(device=m.device, dtype=torch.float32)
        return (m * w).sum(), w.sum()

    return step


def evaluate(loader, eval_step, group=None) -> tuple[float, float]:
    """``(mean metric, weighted example count)`` over a loader. The
    per-batch sums accumulate on the device; the only host sync is the
    fetch at the end. With ``group`` (the ranks that read different eval
    rows) the two sums are summed over it first, so that every rank
    returns the whole eval's. The loader's iterator is closed on every
    path, so that its threads end with the eval."""
    num = den = None
    it = iter(loader)
    try:
        with compiletrack.phase("eval"):
            for batch in it:
                part, count = eval_step(batch)
                num = part if num is None else num + part
                den = count if den is None else den + count
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if group is not None:
        sums = (torch.stack([num, den]) if den is not None
                else torch.zeros(2, dtype=torch.float32))
        num, den = all_reduce(sums, group).unbind()
    if den is None:
        return 0.0, 0.0
    if compiletrack.enabled():
        compiletrack.track_transfer("d2h", 8)
    total = float(den)
    return (float(num) / total if total else 0.0), total


class _DeviceTimes:
    """CUDA event pairs around one piece of device work per step, read at
    log points (:meth:`drain`), so timing adds no host sync of its own. On
    the CPU nothing is timed. Each time read is also observed into
    ``histogram`` when one is given (a registry series)."""

    def __init__(self, cuda: bool, histogram=None):
        self.cuda = cuda
        self.histogram = histogram
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
        if self.histogram is not None:
            for ms in new:
                self.histogram.observe(ms)
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
                losses = all_reduce(losses, None) / self.world
            if compiletrack.enabled():
                compiletrack.track_transfer("d2h", losses.numel() * 4)
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
    the image tasks (classification, contrastive) add ``images_per_sec``
    (the images of the steps after
    the first log point over their wall time, loader waits included, closed
    by a device sync; the whole loop when there is no later step),
    ``images_per_sec_whole_run`` (every image over the whole loop, warm-up
    included) and ``decoder_arm``, contrastive also its caption decoder's
    ``pack_*`` counters; with ``eval_at_end`` every task adds
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
    ``ckpt_wait_ms`` (the part of it awaiting the previous step's write
    and commit), ``ckpt_write_ms`` (each shard write on the writer thread),
    ``ckpt_last_success_step``, ``ckpt_restore_ms``,
    ``ckpt_restore_bytes``, ``ckpt_restore_largest_bytes`` and
    ``ckpt_restore_scanned_bytes`` (this process's restore time, the bytes
    of the leaves and blocks it restored, the largest of them, and the
    shard bytes it read for them; None without a restore), ``ckpt_bytes``
    (this process's shard
    bytes of its newest committed save, 0 when it wrote none) and
    ``ckpt_step_bytes`` (every process's bytes of the newest step). Under
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
    there is no later window).

    Each ``history`` entry also gives the epoch's ``epoch_steps``,
    ``epoch_time``, ``images_per_sec`` (image tasks: its images over its
    wall time, a device sync included), ``replay`` (True for a
    ``device_cache`` replay epoch) and, with ``num_workers``,
    ``worker_results`` (batches the pool decoded that epoch), with
    ``batch_cache`` ``cache_hits``, ``cache_disk_hits`` and
    ``cache_misses``. With ``data_echo > 1`` the result gives
    ``data_echo`` and ``unique_images_per_sec`` (image tasks). With
    ``device_cache``: ``device_cache_batches`` (the replay set's size, 0
    when the guard refused it) and ``device_cache_refused`` (the
    projection and the budget, or None). With ``num_workers``:
    ``worker_transport`` (``shm`` or ``pickle``) and ``shm_fallbacks``.
    With ``autotune``: ``autotune_ticks`` and ``autotune_decisions``.
    Under a sharded layout: ``parallel`` (the mesh, this rank's index on
    it, the transport, and the bytes of parameters, optimizer moments and
    accumulator this rank holds, its plan's and the replicated state's)."""
    _check_loader_config(config)
    if config.placement_depth < 1:
        raise ValueError(
            f"placement_depth must be >= 1, got {config.placement_depth}"
        )
    if config.data_echo < 1:
        raise ValueError(f"data_echo must be >= 1, got {config.data_echo}")
    if config.num_workers < 0:
        raise ValueError(
            f"num_workers must be >= 0, got {config.num_workers}")
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
        if config.seq_parallelism > 1 or config.pipeline_parallelism > 1:
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
        # JAX also refuses token_pack over a data service on a mesh of
        # several devices; a port process drives one card, so the refusal
        # above covers it.
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
    if config.data_service_addr and config.coordinator_addr:
        raise ValueError(
            "data_service_addr and coordinator_addr are mutually exclusive "
            "(one names a single server, the other a fleet's coordinator)"
        )
    if config.job_id and not _remote(config):
        raise ValueError(
            "job_id declares tenancy on a shared data service/fleet — it "
            "needs data_service_addr or coordinator_addr (local decode has "
            "no job plane)"
        )
    if config.job_priority and not config.job_id:
        raise ValueError(
            "job_priority needs an explicit job_id (the implicit default "
            "job always runs at the server's default class)"
        )
    if _remote(config):
        remote_knob = (
            "data_service_addr" if config.data_service_addr
            else "coordinator_addr"
        )
        if (config.data_format != "columnar"
                or config.loader_style != "iterable"):
            raise ValueError(
                f"{remote_knob} needs the iterable columnar path (the "
                "service streams sampler-plan ranges); pass "
                "loader_style='iterable', data_format='columnar'"
            )
        if config.filter or config.val_fraction:
            raise ValueError(
                "filter/val_fraction resolve index pools locally and cannot "
                f"combine with {remote_knob}"
            )
        if config.num_workers > 0:
            warnings.warn(
                "num_workers>0 has no effect with data_service_addr: decode "
                "runs in the remote DataService (size ITS pool with "
                "`ldt serve-data --num_workers N`)",
                stacklevel=3,
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


def _remote(config: TrainConfig) -> bool:
    """Whether the run streams from a data service or a fleet."""
    return bool(config.data_service_addr or config.coordinator_addr)


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


def _assemble(config: TrainConfig, device: torch.device, plane, source,
              decode_node, *mid):
    """One loader of the run as a compiled :class:`~.data.graph.LoaderGraph`
    (the JAX trainer's ``_assemble``): ``source``, ``decode_node`` and the
    arm's own nodes, then the run's page pool, where batches are placed
    (nowhere behind a plane: the engine yields host batches) and the
    placement plane when there is one."""
    nodes = [source, decode_node, *mid,
             Buffers(_loader_buffer_pool(config)),
             Prefetch(config.prefetch, producers=config.producer_threads),
             DevicePut(None if plane is not None else device), InProcess()]
    if plane is not None:
        nodes.append(Place(plane))
    graph = LoaderGraph(*nodes)
    graph.compile()
    return graph


def _make_worker_pool(config: TrainConfig, decode):
    """The run's decode worker pool (the reference's ``num_workers`` with
    ``persistent_workers``), or ``None`` when ``num_workers`` is 0. Its
    workers take a pickled copy of ``decode``; their batches land in pages
    of the run's pool."""
    if config.num_workers <= 0:
        return None
    from .data.workers import WorkerPool, columnar_spec, folder_spec

    transport = "shm" if config.shm_workers else "pickle"
    pool = _loader_buffer_pool(config)
    if config.data_format == "folder":
        samples, _ = _folder_samples(config.dataset_path)
        return WorkerPool(folder_spec(samples), decode, config.num_workers,
                          transport=transport, buffer_pool=pool)
    return WorkerPool(columnar_spec(config.dataset_path), decode,
                      config.num_workers,
                      columns=getattr(decode, "required_columns", None),
                      transport=transport, buffer_pool=pool)


def _build_loader(config: TrainConfig, dataset: Optional[Dataset], decode,
                  device: torch.device, epoch: int, per_process: int,
                  data_index: int, data_world: int,
                  index_pool: Optional[np.ndarray] = None, workers=None,
                  batch_cache=None, folder_fp: Optional[str] = None):
    """This epoch's train loader, one :class:`~.data.graph.LoaderGraph`
    whatever the arm: the iterable range plans, the map-style loader over
    the run's pool, or the folder arm in either style (the source node is
    all that varies), with the JAX trainer's refusals of an empty plan and
    of a folder with more classes than ``num_classes``; fed by the run's
    worker pool and cache when there are, and placed by the placement
    plane unless the synchronous arm is chosen."""
    plane = _make_placement(config, device)
    columns = getattr(decode, "required_columns", None)
    if _remote(config):
        return _build_remote_loader(config, dataset, device, plane, epoch,
                                    per_process, data_index, data_world,
                                    columns)
    if config.data_format == "folder":
        source = FolderSource(
            config.dataset_path, per_process, data_index, data_world,
            loader_style=config.loader_style,
            # Map-style always reshuffles (DistributedSampler semantics);
            # the iterable arm's batch-order shuffle is opt-in, as on the
            # columnar iterable path.
            shuffle=True if config.loader_style == "map" else config.shuffle,
            seed=config.seed, epoch=epoch, dataset_fingerprint=folder_fp)
        loader = _assemble(config, device, plane, source, Decode(decode),
                           Cache(batch_cache), Pool(workers))
        if len(loader) == 0:
            raise ValueError("folder smaller than one global batch")
        if (config.task_type == "classification"
                and loader.num_classes > config.num_classes):
            raise ValueError(
                f"folder has {loader.num_classes} class directories but "
                f"num_classes={config.num_classes}; out-of-range labels "
                "would be silently clamped by the XLA gather"
            )
        return loader
    if config.loader_style == "map":
        if index_pool is not None and len(index_pool) < config.batch_size:
            raise ValueError(
                f"filter {config.filter!r} keeps {len(index_pool)} rows — "
                f"fewer than one global batch ({config.batch_size})"
            )
        source = MapStyleSource(dataset, per_process, data_index, data_world,
                                seed=config.seed, epoch=epoch,
                                index_pool=index_pool)
    else:
        source = LanceSource(dataset, config.sampler_type, per_process,
                             data_index, data_world, shuffle=config.shuffle,
                             seed=config.seed, epoch=epoch)
    loader = _assemble(config, device, plane, source,
                       Decode(decode, columns=columns), Cache(batch_cache),
                       Pool(workers))
    if config.loader_style == "map":
        if len(loader) == 0:
            raise ValueError(
                "empty plan: dataset smaller than one global batch "
                f"({dataset.count_rows()} rows, global batch "
                f"{config.batch_size})"
            )
    else:
        refuse_empty_plan(loader, dataset, per_process, data_world)
    return loader


def _start_exporter(config: TrainConfig, timer: StepTimer, logger):
    """Process 0's ``/metrics`` and ``/healthz`` for the run (the JAX
    trainer's ``--metrics_port``): the process registry (``trainer_*``, a
    remote loader's ``svc_*`` and ``lineage_*``) and the SLO tracker's
    burn rates over the lineage percentiles. Returns ``(exporter,
    tracker)``; the bound port goes to the progress log."""
    from .obs.http import MetricsHTTPServer
    from .obs.slo import SLOTracker

    def _lineage_p99(name: str):
        def probe() -> float:
            hist = default_registry().get(name)
            if hist is None:
                return float("nan")  # no traffic yet: skipped
            return hist.percentile(99)
        return probe

    tracker = SLOTracker(probes={
        "batch_age_p99_ms": _lineage_p99("lineage_batch_age_ms"),
        "queue_wait_p99_ms": _lineage_p99("lineage_queue_wait_ms"),
    }).start()
    try:
        exporter = MetricsHTTPServer(
            default_registry(), port=config.metrics_port,
            host=config.metrics_host,
            healthz_fn=lambda: {"role": "trainer",
                                "run_name": config.run_name,
                                "steps": timer.steps,
                                "slo": tracker.status()},
        ).start()
    except BaseException:
        tracker.stop()
        raise
    logger.log({"metrics_port": exporter.port})
    return exporter, tracker


def _build_remote_loader(config: TrainConfig, dataset: Optional[Dataset],
                         device: torch.device, plane, epoch: int,
                         per_process: int, data_index: int, data_world: int,
                         columns):
    """The remote arm (the JAX trainer's): decode runs in a data service
    (:class:`~.data.graph.ServiceTransport`) or a coordinator's fleet
    (:class:`~.data.graph.FleetTransport`), which build the same plan from
    the same source, so the batches equal local decode's on the same seed.
    This process declares its decode knobs (the server refuses a mismatch)
    and, when it can read the dataset too, the dataset's fingerprint (a
    server reading another copy is refused); it only receives batches and
    places them."""
    source = LanceSource(
        None, config.sampler_type, per_process, data_index, data_world,
        shuffle=config.shuffle, seed=config.seed, epoch=epoch,
        dataset_fingerprint=(dataset.fingerprint() if dataset is not None
                             else None))
    decode_node = Decode(
        columns=columns, task_type=config.task_type,
        image_size=config.image_size,
        seq_len=config.seq_len if config.task_type in _TEXT_TASKS else None,
        device_decode=config.device_decode, token_pack=config.token_pack)
    transport = (
        FleetTransport(config.coordinator_addr, job_id=config.job_id,
                       job_priority=config.job_priority)
        if config.coordinator_addr
        else ServiceTransport(config.data_service_addr, job_id=config.job_id,
                              job_priority=config.job_priority))
    nodes = [source, decode_node, Prefetch(config.prefetch), transport,
             Buffers(_loader_buffer_pool(config)),
             DevicePut(None if plane is not None else device)]
    if plane is not None:
        nodes.append(Place(plane))
    loader = LoaderGraph(*nodes)
    loader.compile()
    if len(loader) == 0:
        raise ValueError(
            "empty plan from data service: dataset smaller than one "
            f"global batch ({config.batch_size})"
        )
    return loader


def _build_eval_loader(config: TrainConfig, device: torch.device, read_fn,
                       total: int, decode, index_pool=None, batch_cache=None,
                       dataset_fingerprint: Optional[str] = None,
                       data_index: int = 0, data_world: int = 1):
    """The eval loader of data share ``data_index`` of ``data_world``, one
    :class:`~.data.graph.LoaderGraph` over an
    :class:`~.data.graph.EvalSource`: its slice of each global eval batch,
    so that the shares read every row (or pool position) once, the tail
    padded, placed as the train loaders are. The ranks of one model
    group, ring or pipeline share a data index and read the same rows."""
    plane = _make_placement(config, device)
    source = EvalSource(read_fn, total, config.batch_size, data_index,
                        data_world, index_pool=index_pool)
    return _assemble(config, device, plane, source, Decode(decode),
                     Cache(batch_cache,
                           dataset_fingerprint=dataset_fingerprint))


def _check_seq_parallelism(config: TrainConfig) -> None:
    """The JAX trainer's refusals of an attention path or a layout it
    cannot take (``_task_from_config``, the fsdp/zero checks), with its
    messages."""
    if config.fsdp and config.zero_opt:
        raise ValueError(
            "fsdp and zero_opt are mutually exclusive: fsdp (ZeRO-3) "
            "already shards the optimizer state along with the params"
        )
    if int(config.zero_opt) not in (0, 1, 2):
        raise ValueError(
            f"zero_opt must be 0, 1 (shard optimizer state) or 2 (also "
            f"shard gradient accumulation), got {config.zero_opt!r}"
        )
    if config.flash_attention and (config.seq_parallelism > 1
                                   or config.pipeline_parallelism > 1):
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
    elif config.pipeline_parallelism > 1:
        if config.task_type != "masked_lm":
            raise ValueError(
                "pipeline_parallelism>1 requires a sequence model (masked_lm)"
            )
    elif config.flash_attention and config.task_type not in ("masked_lm",
                                                             "causal_lm"):
        raise ValueError("flash_attention requires a sequence model")
    if config.pipeline_parallelism > 1 and config.seq_parallelism > 1:
        # get_task's refusal: the ring is the attention path it refuses.
        raise ValueError(
            "pipeline_parallelism composes with dp only "
            "(not seq/flash/moe) in this release"
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
        image_size=config.image_size,
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
        if compiletrack.enabled():
            compiletrack.track_transfer("d2h", len(counts) * 8)
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


_MARKS = {
    # name in a result: (registry series, kind)
    "worker_results": ("workers_result_wait_ms", "histogram"),
    "shm_fallbacks": ("shm_fallback_total", "counter"),
    "cache_hits": ("cache_hit_total", "counter"),
    "cache_disk_hits": ("cache_disk_hit_total", "counter"),
    "cache_misses": ("cache_miss_total", "counter"),
    "autotune_ticks": ("autotune_ticks_total", "counter"),
    "autotune_decisions": ("autotune_decisions_total", "counter"),
}


def _registry_marks() -> dict:
    """The process registry's series that a run reports, read now."""
    reg = default_registry()
    return {name: (reg.histogram(series).count if kind == "histogram"
                   else reg.counter(series).value)
            for name, (series, kind) in _MARKS.items()}


def _registry_deltas(before: dict, after: dict, *, workers: bool,
                     cache: bool) -> dict:
    """The series' growth between two marks: the pool's batches and shm
    fallbacks with a pool, the cache's hits and misses with a cache, the
    tuner's ticks and decisions."""
    names = ["autotune_ticks", "autotune_decisions"]
    if workers:
        names += ["worker_results", "shm_fallbacks"]
    if cache:
        names += ["cache_hits", "cache_disk_hits", "cache_misses"]
    return {n: int(after[n] - before[n]) for n in names}


# How long a failing process waits for its peers to fail too before its
# emergency checkpoint (the timeout of ``CheckpointManager.gate``).
_PEER_WAIT_S = 60.0


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
                     world: int, wait: bool = False, sharded=None,
                     data_index: int = 0) -> None:
    """Every process's mask generator state and data share, gathered, go
    into the cursor; every process saves its share of the state: under a
    sharded layout its blocks (``ShardedState.local_state``), each written
    by one process, else the replicated state, which rank 0 writes."""
    shares = ckpt.all_gather([pack_rng_key(mask_gen), data_index])
    if sharded is not None:
        model_state, opt_state, accum = sharded.local_state(
            optimizer, train_step.accum)
        step_state = dict(train_step.state_dict(), accum=accum)
    else:
        model_state, opt_state = model.state_dict(), optimizer.state_dict()
        step_state = train_step.state_dict()
    cursor = dict(journal.cursor_base)
    cursor.update(global_step=journal.abs_step,
                  rng=[state for state, _ in shares],
                  rng_data_index=[index for _, index in shares])
    ckpt.save(journal.abs_step,
              {"model": model_state, "optimizer": opt_state,
               "optimizer_class": type(optimizer).__name__,
               "train_step": step_state},
              cursor=cursor, wait=wait)
    # An intact duplicate (save returned False) holds this step as well.
    journal.saved_step = journal.abs_step


def _check_saved_tree(tree, names, optimizer) -> None:
    """Refuse a step whose state tree is not this run's: another model (its
    ``state_dict`` names) or another optimizer, as JAX's orbax restore
    refuses a changed tree. A layout change of the same tree is taken (a
    step of the earlier format names no optimizer)."""
    saved, names = set(tree["model"]), set(names)
    if saved != names:
        extra, lacks = sorted(saved - names), sorted(names - saved)
        raise CheckpointRefused(
            f"its model is not this run's: it holds {extra[:3]} that this "
            f"run does not and lacks {lacks[:3]} (another model, or the "
            "pipeline's stacked blocks against separate ones)")
    mine = type(optimizer).__name__
    theirs = tree.get("optimizer_class", mine)
    if theirs != mine:
        raise CheckpointRefused(
            f"its optimizer is not this run's ({theirs} against {mine})")


def _saved_generator(cursor: dict, rank: int, data_index: int) -> list:
    """The saved mask generator state this process continues: that of the
    lowest process that drew for its data share. A layout of as many data
    shares continues each share's draws; under fewer or more (fsdp's two
    against tp's one at the same world size) share ``d`` takes saved
    share ``d`` modulo their number, so that the ranks of one share draw
    alike. A cursor without data shares is the data-parallel runs' (share
    = rank)."""
    rngs = cursor["rng"]
    shares = cursor.get("rng_data_index")
    if shares is None:
        return rngs[rank]
    return rngs[shares.index(data_index % (max(shares) + 1))]


def _restore_checkpoint(ckpt: CheckpointManager, model, optimizer,
                        train_step, sharded, mask_gen, rank: int, world: int,
                        epochs: int, data_index: int = 0):
    """Restore the newest step intact on every process into the live
    objects: ``(start_epoch, epoch_step, global_step)``, or ``None`` when
    there is none. Resuming under a different world size raises. A sharded
    state reads its blocks under this run's layout, whatever layout saved
    the step; a replicated one reads the whole state."""
    def read(reader):
        tree = reader.tree()
        if sharded is None:
            _check_saved_tree(tree, model.state_dict(), optimizer)
            return reader.whole()
        _check_saved_tree(tree, sharded.whole_shapes(), optimizer)
        step_tree = tree["train_step"]
        blocks = sharded.read_sharded_state(
            reader, tree["model"], tree["optimizer"], step_tree.get("accum"),
            optimizer)
        return blocks, dict(step_tree, accum=None)

    restored = ckpt.restore_latest(read)
    if restored is None:
        return None
    state, cursor, step = restored
    rngs = cursor.get("rng") or []
    if len(rngs) != world:
        # The per-process mask generators have no continuation under
        # another process count.
        raise ValueError(
            f"checkpoint step {step} was taken by {len(rngs)} processes; "
            f"this run has {world}")
    if sharded is not None:
        (model_blocks, opt_state, saved_accum), step_state = state
        train_step.load_state_dict(step_state)
        sharded.load_sharded_state(model_blocks, opt_state, saved_accum,
                                   optimizer, train_step.accum)
    else:
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        train_step.load_state_dict(state["train_step"])
    unpack_rng_key(_saved_generator(cursor, rank, data_index), mask_gen)
    start_epoch = min(int(cursor.get("epoch", 0)), epochs)
    epoch_step = int(cursor.get("step", 0)) if start_epoch < epochs else 0
    return start_epoch, epoch_step, int(cursor.get("global_step", step))


def _sharded_layout(config: TrainConfig) -> bool:
    """Whether the run's state is laid out by the plan (parallel/layout.py)
    rather than replicated under DDP: a layout beyond DP was asked for."""
    return (config.model_parallelism > 1 or config.pipeline_parallelism > 1
            or config.fsdp or int(config.zero_opt) > 0)


def _warm_vector_math() -> None:
    """One vector-math call on this thread before any on two. torch's
    ``sqrt`` reaches MKL's vector math, and a process's first AdamW step
    splits its first parameter's ``sqrt`` between the intra-op threads: on
    two threads one half came back with relative errors up to 2.6e-4 in
    about 4% of fresh processes, and in none with this call first (ROADMAP
    Queue 3; ``tests/test_torch_resume.py``)."""
    torch.ones(1).sqrt()


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
    else:
        _warm_vector_math()
    cuda = device.type == "cuda"
    sp = config.seq_parallelism
    # The data share this process reads: its rank's, or with a process ring
    # or a layout beyond DP its data index's, which the ranks of its model
    # shards, ring positions and pipeline stages share.
    data_index, data_world, seq_index = rank, world, 0
    ring = topo = None
    loss_group = dist.group.WORLD if world > 1 else None
    if _sharded_layout(config) or (sp > 1 and world > 1):
        topo = Topology(rank, world, config.model_parallelism,
                        sp if world > 1 else 1, config.pipeline_parallelism)
        data_index, data_world = topo.index["data"], topo.size["data"]
        seq_index = topo.index["seq"]
        loss_group = topo.batch_group
        if sp > 1 and world > 1:
            ring = ProcessRing(topo.group["seq"], topo.ranks["seq"])
    per_process, rem = divmod(config.batch_size, data_world)
    if rem:
        raise ValueError(f"global batch {config.batch_size} not divisible by "
                         f"{data_world} processes")
    image = config.task_type in _IMAGE_TASKS
    folder = config.data_format == "folder"
    remote = _remote(config)
    if folder:
        dataset = None
    elif remote:
        # The training host may not mount the dataset at all: the reads
        # run on the service host. Opened when present, for the eval and
        # the schedule horizon.
        try:
            dataset = Dataset(config.dataset_path)
        except FileNotFoundError:
            dataset = None
    else:
        dataset = Dataset(config.dataset_path)
    if (dataset is None and remote
            and (config.eval_at_end or config.eval_every)
            and not config.val_dataset_path):
        raise ValueError(
            "eval needs the dataset readable on this host (eval reads rows "
            f"directly, not through the data service): {config.dataset_path} "
            "is absent — mount it, pass val_dataset_path, or disable eval "
            "(eval_at_end=False, eval_every=0)"
        )
    # The folder arm evaluates its own tree: a val dataset is columnar.
    val_dataset = (Dataset(config.val_dataset_path)
                   if config.val_dataset_path and not folder else None)
    init_gen = torch.Generator().manual_seed(config.seed)
    attention_fn = None
    if image and cuda:
        torch.backends.cudnn.benchmark = True  # conv autotuning, as XLA
    if config.task_type == "classification":
        task = get_task("classification", num_classes=config.num_classes,
                        model_name=config.model_name,
                        image_size=config.image_size, augment=config.augment,
                        device=device, generator=init_gen)
    elif config.task_type == "contrastive":
        task = get_task("contrastive", model_name=config.model_name,
                        image_size=config.image_size, seq_len=config.seq_len,
                        vocab_size=config.vocab_size, augment=config.augment,
                        device=device, generator=init_gen,
                        loss_group=loss_group)
    else:
        if sp > 1:
            attention_fn = make_ring_attention(sp, ring)
        elif config.flash_attention:
            # causal_lm binds the kernels' causal mask.
            attention_fn = make_flash_attention(
                causal=config.task_type == "causal_lm")
        task = get_task(config.task_type, model_name=config.model_name,
                        seq_len=config.seq_len, vocab_size=config.vocab_size,
                        attention_fn=attention_fn, remat=config.remat,
                        num_experts=config.num_experts,
                        moe_every=config.moe_every,
                        pipeline_parallelism=config.pipeline_parallelism,
                        pp_microbatches=config.pp_microbatches,
                        device=device, generator=init_gen,
                        loss_group=loss_group)
        if ring is not None:
            # A ring's members hold sequence blocks of the same rows: the
            # MoE layers count the queues in the global row-major order.
            set_moe_group(task.model, loss_group, sp)

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
    sharded = plan = None
    if _sharded_layout(config):
        # The layout plan on the whole model (built alike on every rank),
        # then this rank's blocks; the sharded state replaces DDP.
        rules = (rules_for_task(task.name, config.model_name)
                 if config.model_parallelism > 1
                 or config.pipeline_parallelism > 1 else ())
        plan = plan_model(flax_named_shapes(task.model), rules, topo.size,
                          fsdp=config.fsdp, zero_level=int(config.zero_opt))
        shard_model_(task.model, plan, topo)
        sharded = ShardedState(task.model, plan, topo,
                               max(config.grad_accum, 1))
        set_sync_group(task.model, loss_group)
        if rank == 0:
            print(f"[parallel] mesh={ {a: n for a, n in topo.size.items()} } "
                  f"transport={transport_name()} "
                  f"fsdp={config.fsdp} zero={int(config.zero_opt)}",
                  flush=True)
    elif world > 1:
        set_sync_group(task.model, loss_group)
        ddp = DistributedDataParallel(
            task.model, device_ids=[device.index] if cuda else None,
            broadcast_buffers=False)
        train_task = task.with_model(ddp)
    # The image tasks draw one flip per image of the global batch and each
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
        if dataset is None and remote:
            raise ValueError(
                "lr_schedule needs a horizon, and the dataset is not "
                "readable on this host to derive one — pass total_steps "
                "explicitly with data_service_addr"
            )
        rows = (len(index_pool) if index_pool is not None
                else len(samples) if folder else dataset.count_rows())
        # Echoes are real optimizer steps.
        total_steps = (max(rows // config.batch_size, 1) * config.epochs
                       * config.data_echo)
    optimizer, lr = make_optimizer(
        config, sharded.masters if sharded is not None
        else task.model.parameters(), total_steps)
    accum = max(config.grad_accum, 1)
    fold_times = _DeviceTimes(cuda)
    step = make_train_step(train_task, optimizer, lr, config.grad_clip,
                           grad_accum=accum, grad_norm=config.log_grad_norm,
                           fold_times=fold_times, sharded=sharded)

    # Checkpoint/resume: the newest INTACT step restores the model, the
    # optimizer, the accumulator and the generators together with the
    # data-plane cursor (epoch, batches consumed, absolute step), so the
    # resumed stream — and with it the loss trajectory — is the
    # uninterrupted run's. Across processes the checkpoint's collectives
    # go over gloo groups of their own, apart from the training's.
    ckpt = None
    if config.checkpoint_dir:
        ckpt = CheckpointManager(config.checkpoint_dir) if world == 1 else \
            CheckpointManager(
                config.checkpoint_dir, group=dist.new_group(backend="gloo"),
                gate=dist.new_group(backend="gloo", timeout=timedelta(
                    seconds=_PEER_WAIT_S)))
    start_epoch = resume_epoch_step = resume_global_step = 0
    restore_ms = None
    if ckpt is not None and config.resume:
        t0 = time.perf_counter()
        resumed = _restore_checkpoint(ckpt, task.model, optimizer, step,
                                      sharded, mask_gen, rank, world,
                                      config.epochs, data_index)
        if resumed is not None:
            start_epoch, resume_epoch_step, resume_global_step = resumed
            if cuda:
                torch.cuda.synchronize(device)  # ldt: ignore[LDT1714] -- once, before the first step: times the restore's copies to the card
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
    # The registry's series of the stage, as the JAX trainer's: the host
    # time of each transform call, and the device times read from events
    # (decode_device_ms feeds the tuner's decode_split).
    registry = default_registry()
    transform_ms = registry.histogram("trainer_transform_ms")
    transform_times = _DeviceTimes(
        cuda, registry.histogram(device_ms_key) if device_ms_key else None)
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

    # The eval runs on every rank under the run's layout, as JAX's sharded
    # eval step does: each data share reads its slice of each global eval
    # batch (the ranks of one model group, ring or pipeline the same
    # slice), and the (sum, count) pairs are summed over the data shares.
    if topo is not None:
        eval_group = topo.group["data"]
    else:
        eval_group = dist.group.WORLD if world > 1 else None
    eval_seq = ((seq_index, sp, topo.group["seq"]) if ring is not None
                else None)

    def run_eval():
        """Every row (or pool position) of the eval data once, split over
        the data shares: ``(accuracy, rows)``, the same on every rank."""
        nonlocal eval_pool
        eval_decode = (decode if config.task_type == "classification"
                       else _decoder_for(config, for_eval=True))
        if folder:
            def read_fn(idx):
                return read_sample_batch(samples, idx)
            total = len(samples)
        else:
            columns = getattr(eval_decode, "required_columns", None)

            def read_fn(idx):
                return eval_dataset.take(idx, columns=columns)
            total = eval_dataset.count_rows()
            if config.filter and eval_pool is None:
                eval_pool = eval_dataset.filter_indices(config.filter)
        loader = _build_eval_loader(
            config, device, read_fn, total, eval_decode,
            index_pool=eval_pool, batch_cache=batch_cache,
            dataset_fingerprint=(folder_fp if folder else
                                 eval_dataset.fingerprint()),
            data_index=data_index, data_world=data_world)
        eval_step = make_eval_step(task, eval_seq)
        if coeff:
            eval_step = (lambda b, _step=eval_step: _step(transform(b)))
        if sharded is not None:
            sharded.gather_params()
        try:
            return evaluate(loader, eval_step, eval_group)
        finally:
            if sharded is not None:
                sharded.release_params()

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
                         mask_gen, rank, world, wait=wait, sharded=sharded,
                         data_index=data_index)

    pool = _loader_buffer_pool(config)
    pool_start = pool.counters() if pool is not None else None
    placement_ms: list[float] = []  # each train batch's placement
    h2d_windows: list[tuple] = []  # (placement s, loader + step s) a window
    global_step = 0  # this run's micro-steps
    stop = False
    history = []
    lo, hi = data_index * per_process, (data_index + 1) * per_process
    def log_progress(epoch: int, global_step: int) -> None:
        """One progress line: the window since the last one, after the
        window's one host sync."""
        nonlocal warm, entropy_seen
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
            extra[device_ms_key] = _mean(transform_times.drain())
        if coeff:
            # The decoder's batches since the last log (its producer
            # thread may run ahead of the steps).
            seen = len(decode.entropy_ms)
            extra["decode_entropy_ms"] = _mean(
                decode.entropy_ms[entropy_seen:seen])
            entropy_seen = seen
        # Schedules count optimizer updates, not micro-steps; the restored
        # step count carries the position across a resume.
        updates = (resume_global_step + global_step) // accum
        extra["lr"] = float(lr(updates) if callable(lr) else lr)
        if config.log_grad_norm:
            extra["grad_norm"] = round(float(step.last_grad_norm), 4)
        if accum > 1:
            fold_times.drain()
        extra = {k: v for k, v in extra.items() if v is not None}
        busy = w["loader_s"] + w["step_s"]
        if "placement_h2d_s" in w:
            # Placement time of the window (on its own thread, beside the
            # step) as a share of the same loader-plus-step time.
            extra["h2d_pct"] = (100.0 * w["placement_h2d_s"] / busy
                                if busy > 0 else 0.0)
            h2d_windows.append((w["placement_h2d_s"], busy))
            extra["placement_buffer_depth"] = int(
                w.get("placement_buffer_depth", 0))
        if config.data_echo > 1:
            # The window counts echoed steps; the unique-data rate beside.
            extra["data_echo"] = config.data_echo
            if image:
                extra["unique_images_per_sec"] = (w["images_per_sec"]
                                                  / config.data_echo)
        logger.log({
            "step": global_step,
            "epoch": epoch,
            "loss": round(log.losses[-1], 4),
            "step_ms": w["step_ms"],
            **rates,
            "loader_stall_pct": (100.0 * w["loader_s"] / busy
                                 if busy > 0 else 0.0),
            **extra,
        })

    # The HBM replay tier (device_cache): the first streamed epoch's
    # batches, after the transform stage, replayed in later epochs.
    dev_cache = DeviceReplayCache(enabled=config.device_cache,
                                  budget_gb=config.device_cache_gb,
                                  seed=config.seed)
    dev_refused = None
    worker_pool = batch_cache = tuner = exporter = slo_tracker = None
    folder_fp = None
    registry_start = _registry_marks()
    t_start = time.perf_counter()
    warm = None  # (steps, time) at the first log point: warm-up ends there
    try:
        if config.metrics_port is not None and rank == 0:
            exporter, slo_tracker = _start_exporter(config, timer, logger)
        # A remote arm decodes on the server, where its pool and its cache
        # live (serve-data --num_workers, --batch_cache).
        worker_pool = None if remote else _make_worker_pool(config, decode)
        if config.batch_cache and not remote:
            # One cache a run: the epoch loop rebuilds the loaders, the
            # cache outlives them (epoch 2 hits what epoch 1 filled).
            batch_cache = BatchCache(
                cache_dir=config.cache_dir,
                ram_budget_mb=config.cache_ram_budget_mb,
                disk_budget_mb=config.cache_disk_budget_mb,
                buffer_pool=pool)
            if folder:
                # The corpus's identity, hashed once a run.
                folder_fp = folder_fingerprint(samples)
        if config.autotune:
            # One controller a run; each epoch registers its loader's knobs.
            tuner = AutoTuner(interval_s=config.autotune_interval_s).start()
        for epoch in range(start_epoch, config.epochs):
            # The cursor of a resumed epoch: batches already consumed.
            resume_step = resume_epoch_step if epoch == start_epoch else 0
            replay_it = dev_cache.replay_iter(
                epoch, start_epoch,
                shuffled=config.shuffle or config.loader_style == "map")
            replay = replay_it is not None
            if replay:
                loader, it = None, replay_it
            else:
                loader = _build_loader(config, dataset, decode, device, epoch,
                                       per_process, data_index, data_world,
                                       index_pool, workers=worker_pool,
                                       batch_cache=batch_cache,
                                       folder_fp=folder_fp)
                if resume_step:
                    # The rebuilt plan is a pure function of (pool, shard,
                    # seed, epoch): the tail it serves from the cursor is
                    # what the uninterrupted run consumed.
                    loader.load_state_dict({"epoch": epoch,
                                            "step": resume_step})
                it = iter(loader)
            if tuner is not None:
                # This epoch's live knobs; a replay epoch has no pipeline,
                # so a stale epoch's knobs are never moved.
                tuner.set_tunables(
                    collect_tunables(loader, worker_pool, pool, batch_cache)
                    if loader is not None else [])
            # A resumed epoch never seeds the replay set.
            filling = dev_cache.start_fill(replay, resume_step)
            epoch_steps = 0
            epoch_marks = _registry_marks()
            epoch_t0 = time.perf_counter()
            # The plane's placement_* windows ride the progress lines.
            timer.attach_counters(getattr(loader, "placement_counters", None))
            try:
                while not stop:
                    timer.loader_start()
                    batch = next(it, None)
                    timer.loader_stop()
                    if batch is None:
                        break
                    journal.at_boundary = False
                    fed = batch  # the loader's batch, for the token counts
                    digest = None  # the step trace's, once a host batch
                    for echo in range(config.data_echo):
                        if profile is not None and epoch == start_epoch:
                            profile.at(epoch_steps)
                        timer.step_start()
                        start = log.start()
                        if not image:
                            tokens.add(fed)
                        if echo == 0 and transform is not None and not replay:
                            # A replayed batch was transformed when cached.
                            t0 = time.perf_counter()
                            batch = transform_times.run(transform, batch)
                            transform_ms.observe(
                                (time.perf_counter() - t0) * 1e3)
                        if echo == 0 and filling:
                            refused = dev_cache.admit(batch, len(loader))
                            if refused is not None:
                                # The first batch's projection is over the
                                # budget: stream, and say why.
                                filling = False
                                dev_refused = refused
                                logger.log({
                                    "device_cache": "disabled",
                                    "projected_per_device_gb": round(
                                        refused["projected"] / 1e9, 3),
                                    "limit_per_device_gb": round(
                                        refused["budget"] / 1e9, 3)})
                        # Each echo is a real optimizer step with a fresh
                        # draw of the flips or the MLM mask.
                        if image and config.augment:
                            # One draw over the global batch, sliced per
                            # process: the flips do not depend on the world
                            # size.
                            draw = torch.rand(config.batch_size,
                                              generator=mask_gen,
                                              device=device) < 0.5
                            loss = step(batch, flip_mask=draw[lo:hi])
                        elif ring is not None:
                            # The ring's members draw alike over the whole
                            # rows and each trains on its sequence block.
                            block, drawn = _sequence_block(
                                batch, draw_mlm_mask(batch, mask_gen),
                                seq_index, sp)
                            loss = step(block, mlm_mask=drawn)
                        else:
                            loss = step(batch, mask_gen)
                        log.stop(start, loss)
                        timer.step_stop()
                        epoch_steps += 1
                        global_step += 1
                        if trace is not None:
                            # The batch the step trained on, after the
                            # transform stage, as the JAX trainer records.
                            digest = digest or batch_digest(batch)
                            trace.record(resume_global_step + global_step,
                                         epoch, batch, loss, digest=digest)
                        if 0 < config.max_steps <= global_step:
                            stop = True
                        if (config.log_every
                                and global_step % config.log_every == 0):
                            log_progress(epoch, global_step)
                        if stop:
                            break
                    # Host-batch boundary: the live state pairs with the
                    # cursor naming the NEXT batch (batches handed out so
                    # far). A replay epoch's stream is the cached set in a
                    # cache-local order, so its cursor pins the epoch's
                    # start: a restart streams that epoch again.
                    journal.abs_step = resume_global_step + global_step
                    journal.cursor_base = (
                        loader.state_dict() if loader is not None
                        else {"epoch": epoch, "step": 0})
                    journal.at_boundary = True
                    if (ckpt is not None and config.checkpoint_every_steps > 0
                            and journal.abs_step >= journal.saved_step
                            + config.checkpoint_every_steps):
                        # ">= saved + N" rather than "% N", as the JAX
                        # loop: echoes jump several steps at once.
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
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                timer.attach_counters()
            plane = getattr(loader, "plane", None)
            if plane is not None:
                placement_ms.extend(plane.h2d_ms)
            if profile is not None:
                profile.stop()  # an epoch shorter than the trace window
            if epoch_steps:
                log.drain()  # a device sync: the epoch's work is done
                epoch_time = time.perf_counter() - epoch_t0
                mean = statistics.fmean(log.losses[-epoch_steps:])
                entry = {"epoch": epoch, "train_loss": mean,
                         "epoch_steps": epoch_steps,
                         "epoch_time": epoch_time, "replay": replay}
                if image:
                    entry["images_per_sec"] = (
                        config.batch_size * epoch_steps / epoch_time)
                entry.update(_registry_deltas(
                    epoch_marks, _registry_marks(),
                    workers=worker_pool is not None,
                    cache=batch_cache is not None))
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
                # when the live state sits at that step's boundary on
                # every process: each saves its share. Across processes
                # only when every process failed: a peer blocked in a
                # training collective never comes, and then nothing is
                # committed, a pending step neither, and a restart falls
                # back past it.
                if ckpt.peers_present():
                    ready = ckpt.all_gather(
                        (journal.dirty and journal.at_boundary,
                         journal.abs_step))
                    if ready[0][0] and ready.count(ready[0]) == world:
                        save(wait=True)
                    ckpt.close()
                else:
                    ckpt.close(commit=False)
            except Exception:  # noqa: BLE001 — never mask the run's error
                pass
        raise
    finally:
        try:
            if profile is not None:
                profile.stop()
        finally:
            # The tuner first (it must not resize a pool that is shutting
            # down), then the pool, then the cache, whose RAM leases go
            # back once no loader reads it; its disk tier stays.
            if tuner is not None:
                tuner.stop()
            if exporter is not None:
                exporter.stop()
            if slo_tracker is not None:
                slo_tracker.stop()
            if worker_pool is not None:
                worker_pool.shutdown()
            if batch_cache is not None:
                batch_cache.close()
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
        if config.task_type == "contrastive":
            results.update(decode.counters())  # the captions' pack_* counts
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
            ckpt_save_ms=ckpt.save_ms, ckpt_wait_ms=ckpt.wait_ms,
            ckpt_write_ms=ckpt.write_ms,
            ckpt_last_success_step=ckpt.last_success_step,
            ckpt_restore_ms=restore_ms,
            ckpt_restore_bytes=ckpt.restore_bytes,
            ckpt_restore_largest_bytes=ckpt.restore_largest,
            ckpt_restore_scanned_bytes=ckpt.restore_scanned,
            ckpt_bytes=(ckpt.bytes_written[-1] if ckpt.bytes_written
                        else None),
            ckpt_step_bytes=(ckpt.step_bytes(newest)
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
    if config.data_echo > 1:
        results["data_echo"] = config.data_echo
        if image:
            results["unique_images_per_sec"] = (results["images_per_sec"]
                                                / config.data_echo)
    if config.device_cache:
        results.update(device_cache_batches=len(dev_cache),
                       device_cache_refused=dev_refused)
    marks = _registry_deltas(registry_start, _registry_marks(),
                             workers=worker_pool is not None,
                             cache=batch_cache is not None)
    if worker_pool is not None:
        results.update(worker_transport=worker_pool.transport,
                       shm_fallbacks=marks["shm_fallbacks"])
    if batch_cache is not None:
        results.update(cache_hits=marks["cache_hits"],
                       cache_disk_hits=marks["cache_disk_hits"],
                       cache_misses=marks["cache_misses"],
                       cache_stats=batch_cache.stats())
    if config.autotune:
        results.update(autotune_ticks=marks["autotune_ticks"],
                       autotune_decisions=marks["autotune_decisions"])
    if accum > 1:
        fold_times.drain()
        results["accum_fold_ms"] = (statistics.median(fold_times.ms)
                                    if fold_times.ms else None)
    if profile is not None:
        results["profile_trace"] = profile.path
    if sharded is not None:
        held = sharded.held_bytes(optimizer, step.accum)
        moments = 2 if config.optimizer == "adamw" else int(
            config.momentum != 0)
        results["parallel"] = {
            "mesh": dict(topo.size), "index": dict(topo.index),
            "transport": transport_name(), "fsdp": config.fsdp,
            "zero": int(config.zero_opt), "held_bytes": held,
            "peak_bytes": dict(sharded.peaks),
            "fsdp_unit_bytes": sharded.unit_bytes(),
            "plan_bytes": plan_bytes(plan, topo.size, moments=moments,
                                     accum=accum > 1),
            "replicated_bytes": plan_bytes(
                {k: dataclasses.replace(v, param=None, moment=None,
                                        accum=None)
                 for k, v in plan.items()}, topo.size, moments=moments,
                accum=accum > 1)}
        sharded.materialize()
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
