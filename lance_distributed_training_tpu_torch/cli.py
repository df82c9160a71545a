"""CLI — the port's ``train`` and the subcommands of its input plane.

Counterpart of ``lance_distributed_training_tpu/cli.py`` for the ported
paths, image classification (its defaults: ResNet-50, 224 px, 101 classes,
global batch 512, SGD lr 0.05 momentum 0.9, flips, eval at the end; the
ViTs by ``--model_name vit_tiny|vit_small|vit_base``), CLIP contrastive
image-caption training (``--task_type contrastive``, default
``clip_resnet50_bert``; ``clip_tiny``), masked-LM and causal-LM text with
switch-MoE blocks (``--num_experts N --moe_every K``) and with
``--token_pack`` (ragged pages, an FFD
plan and K3 packing on the device), ``--seq_parallelism`` (masked-LM
through ring attention), ``--device_decode`` (JPEG decode split
at the entropy boundary, K2 on the device), plus ``--device {cuda,cpu}``
(default ``cuda``, which raises when no card is present). The trainer's
surface beyond the main path comes with the JAX defaults:
``--grad_accum``, ``--checkpoint_dir`` (resume from the newest intact
checkpoint; ``--checkpoint_every``, ``--checkpoint_every_steps``,
``--no_resume``), ``--eval_every`` with ``--val_dataset_path``,
``--log_grad_norm``, ``--profile_dir``, ``--run_name`` and ``--no_wandb``;
and the other loaders: ``--loader_style map`` (a ``DistributedSampler``
permutation each epoch, rows gathered by random access) with ``--filter``
and ``--val_fraction``, and ``--data_format folder`` (the file-based
control arm, an image-folder tree, in either loader style). The way from
host to card takes the JAX defaults: pooled decode pages
(``--no_buffer_pool`` turns them off), ``--producer_threads 4`` decode
threads, and the placement plane with a ring of ``--placement_depth 2``
(``--no_global_batch`` is the synchronous control arm);
``--pretrained`` fine-tunes a ResNet from a torchvision checkpoint.
The worker pool, the caches and the autotuner take the JAX defaults too:
``--num_workers 0`` (N > 0 decodes in N spawned processes, through
shared-memory slots unless ``--no_shm_workers``), ``--batch_cache`` off
(``--no_batch_cache``; ``--cache_dir``, ``--cache_ram_budget_mb 512``,
``--cache_disk_budget_mb 2048``), ``--device_cache`` off
(``--device_cache_gb 8``), ``--data_echo 1``, and the autotuner on
(``--no_autotune``, ``--autotune_interval_s 1.0``).
The disaggregated input plane: ``--data_service HOST:PORT`` streams the
batches from a ``serve-data`` server, ``--coordinator HOST:PORT`` from a
fleet of them behind a ``coordinator`` (``--job_id``/``--job_priority``
declare the run's job there), and ``--metrics_port`` serves ``/metrics``
and ``/healthz`` for the run (``--metrics_host``). The host processes of
that plane are subcommands with the JAX CLI's parsers and exit codes:
``serve-data``, ``coordinator``, ``fleet recommend`` (3 = scale up),
``jobs list|describe`` (4 = unknown job), ``protocol goldens``, ``trace
export|critical-path`` and ``costs report``; none touches a card. The
static checker is ``check`` (exit 0 = no new findings against the port's
empty baseline; ``--lock-witness``, ``--leak-witness``, ``--wire-witness``
and ``--compile-witness`` join a sanitized run's evidence) and ``graph``
(``--dot --ownership --protocol --loader --mesh``), over the port with
its own ``analysis/ldt-check.toml``, or over a ``--root`` whose
``pyproject.toml`` has a ``[tool.ldt-check]`` table. The JAX
runtime's flags (``--backend``, ``--num_cpu_devices``,
``--no_compile_cache``, ``--compile_cache_dir``) raise: the port picks its
device with ``--device`` and has no XLA compile cache. Any other flag of
the JAX CLI raises "not yet ported". Model and vocabulary default per task (``--vocab_size`` unset keeps the model's
own: 30522 for BERT and CLIP-ResNet-50, 50257 for GPT, 1000 for
``clip_tiny``). Usage::

    python -m lance_distributed_training_tpu_torch.cli train \\
        --dataset_path /data/food101 --max_steps 20 [--device_decode]
    python -m lance_distributed_training_tpu_torch.cli train \\
        --dataset_path /data/c4_tokens --task_type masked_lm \\
        --model_name bert_base --seq_len 512 --flash_attention \\
        --batch_size 32 --optimizer adamw --lr 1e-4 --max_steps 20
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/web_tokens --task_type causal_lm \
        --model_name gpt_base --seq_len 1024 --token_pack --flash_attention \
        --batch_size 64 --optimizer adamw --lr 1e-4 --max_steps 20
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/laion_subset --task_type contrastive \
        --seq_len 77 --token_pack --optimizer adamw --lr 1e-4 --max_steps 20
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --model_name vit_base --batch_size 256 \
        --device_decode --max_steps 20
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/c4_tokens --task_type masked_lm \
        --model_name bert_base --seq_len 512 --flash_attention \
        --num_experts 8 --moe_every 2 --batch_size 32 --optimizer adamw \
        --lr 1e-4 --max_steps 20

The map-style loader on a filtered pool with a seeded held-out tenth, and
the folder arm (authored with ``python -m
lance_distributed_training_tpu_torch.data.authoring``)::

    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --loader_style map \
        --filter "label < 50" --val_fraction 0.1 --eval_every 1 \
        --max_steps 20 --device_decode
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101_files --data_format folder \
        --loader_style map --max_steps 20

Four decode workers, a batch cache for the second epoch on, and the
autotuner's decisions recorded for replay; then two host batches a step
from an epoch kept on the card::

    LDT_AUTOTUNE_TRACE=/tmp/at.jsonl \
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --num_workers 4 --batch_cache \
        --cache_dir /local/ldt-cache --epochs 2
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --device_decode --device_cache \
        --data_echo 2 --epochs 2

Fine-tuning a torchvision ResNet-50 checkpoint with a fresh 101-class head,
and the synchronous control arm of the same run::

    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --pretrained /ckpt/resnet50.pt
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --pretrained /ckpt/resnet50.pt \
        --no_global_batch --producer_threads 1 --no_buffer_pool

Resume after a preemption: rerun the same command; with
``--checkpoint_dir`` it continues from the newest intact checkpoint (SIGTERM
takes an emergency checkpoint of the last completed step)::

    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/c4_tokens --task_type masked_lm \
        --model_name bert_base --seq_len 512 --flash_attention \
        --batch_size 32 --grad_accum 4 --optimizer adamw --lr 1e-4 \
        --checkpoint_dir /ckpt/bert --checkpoint_every_steps 500

Decode on another host: a server there (no card), the trainer here; or a
fleet of servers behind a coordinator, each on its own host::

    python -m lance_distributed_training_tpu_torch.cli serve-data \
        --dataset_path /data/food101 --port 8476 --device_decode
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/food101 --data_service decode-host:8476 \
        --device_decode --metrics_port 0 --max_steps 20
    python -m lance_distributed_training_tpu_torch.cli coordinator --port 8470
    python -m lance_distributed_training_tpu_torch.cli serve-data \
        --dataset_path /data/web_tokens --task_type causal_lm \
        --seq_len 1024 --token_pack --coordinator coord-host:8470
    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/web_tokens --task_type causal_lm \
        --seq_len 1024 --token_pack --flash_attention --batch_size 64 \
        --coordinator coord-host:8470 --job_id gpt --max_steps 20
    python -m lance_distributed_training_tpu_torch.cli jobs list \
        --coordinator coord-host:8470

Data parallel over N processes: run one per process with
``--coordinator_address host:port --num_processes N --process_id i``.
``--seq_parallelism K`` (masked-LM) runs attention as a ring over K
sequence blocks (K5): in the one process, or over K processes a ring when
N > 1 (N divisible by K)::

    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/c4_tokens --task_type masked_lm \
        --model_name bert_base --seq_len 512 --batch_size 32 \
        --seq_parallelism 4 --optimizer adamw --lr 1e-4 --max_steps 20

Beyond DP, as the JAX CLI: ``--model_parallelism M`` (tensor parallelism
of the transformer blocks, the vocabulary and, with ``--num_experts``,
the experts), ``--fsdp``, ``--zero [1|2]`` and ``--pipeline_parallelism P
--pp_microbatches K`` (the GPipe masked-LM), the ranks laid out as JAX's
``(data, model, seq, pipe)`` mesh (``parallel/comm.py``) by the plan of
``parallel/sharding.py``. Ranks that share a card run gloo with their
CUDA tensors staged through the host.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["build_parser", "main"]


def __getattr__(name):
    # The trainer (and torch with it) loads when a run starts, not when
    # this module is imported: a spawned decode worker of a run started
    # with ``python -m ...cli`` re-imports this module.
    if name in ("TrainConfig", "train"):
        from . import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# Flags of the JAX CLI that configure XLA's runtime: accepted by the parser
# so that they raise with the reason rather than as unrecognised.
_XLA_FLAGS = ("backend", "num_cpu_devices", "no_compile_cache",
              "compile_cache_dir")


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        if "unrecognized arguments" in message:
            raise NotImplementedError(
                f"{message}: this flag of the JAX CLI is not yet ported to "
                "the PyTorch package"
            )
        super().error(message)


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(description="PyTorch/CUDA trainer (classification, "
                            "masked-LM, causal-LM, contrastive)")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--val_dataset_path", type=str, default=None,
                   help="held-out dataset for --eval_every and the eval at "
                        "the end (default: the train data)")
    p.add_argument("--val_fraction", type=float, default=0.0,
                   help=">0: carve a seeded held-out fraction of the train "
                        "dataset as the val split (map-style columnar path; "
                        "composes with --filter)")
    p.add_argument("--task_type", type=str, default="classification",
                   choices=["classification", "masked_lm", "causal_lm",
                            "contrastive"])
    p.add_argument("--num_classes", type=int, default=101)
    p.add_argument("--sampler_type", type=str, default="batch",
                   choices=["batch", "fragment", "full", "sharded_batch",
                            "sharded_fragment", "full_scan"])
    p.add_argument("--loader_style", type=str, default="iterable",
                   choices=["iterable", "map"])
    p.add_argument("--filter", type=str, default=None,
                   help="row predicate, e.g. \"label < 50\" or "
                        "\"label >= 10 & label != 13\" (map-style columnar "
                        "path; resolved to an index pool once)")
    p.add_argument("--data_format", type=str, default="columnar",
                   choices=["columnar", "folder"],
                   help="folder = the file-reading control arm (an "
                        "image-folder tree)")
    p.add_argument("--batch_size", type=int, default=512,
                   help="GLOBAL batch size across all processes")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max_steps", type=int, default=0,
                   help=">0: stop after N train steps regardless of epochs")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw"])
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--grad_clip", type=float, default=0.0)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate N micro-batches per optimizer update "
                        "(optax.MultiSteps semantics); --total_steps and "
                        "--warmup_steps count micro-steps")
    p.add_argument("--no_ddp", action="store_true",
                   help="single process even with --coordinator_address")
    p.add_argument("--model_name", type=str, default=None,
                   choices=["resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152", "vit_tiny", "vit_small", "vit_base",
                            "bert_base", "bert_small", "gpt_base",
                            "gpt_small", "clip_resnet50_bert", "clip_tiny"],
                   help="default per task: resnet50 / bert_base / gpt_base "
                        "/ clip_resnet50_bert")
    p.add_argument("--pretrained", type=str, default=None,
                   help="path to a torch.save'd torchvision ResNet "
                        "state_dict: fine-tune from its backbone weights "
                        "(the reference's pretrained-ResNet50 task shape)")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=None,
                   help="token vocabulary; default = the model's own "
                        "(bert_*, clip_resnet50_bert: 30522, gpt_*: 50257, "
                        "clip_tiny: 1000)")
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--producer_threads", type=int, default=4,
                   help="decode-producer threads (cross-batch decode "
                        "overlap; with --no_global_batch they also "
                        "place each batch)")
    p.add_argument("--placement_depth", type=int, default=2,
                   help="placed batches the placement plane keeps "
                        "transferred ahead of the step (default 2 = "
                        "double-buffered H2D)")
    p.add_argument("--no_global_batch", action="store_true",
                   help="disable the placement plane: place each batch "
                        "synchronously on the consumer thread and the "
                        "compute stream (control arm; batches stay "
                        "bit-identical, H2D lands inside loader stall)")
    p.add_argument("--no_buffer_pool", action="store_true",
                   help="disable the recycled decode buffer pool — every "
                        "batch allocates fresh pages (bufpool_* counts stay "
                        "at zero)")
    p.add_argument("--num_workers", type=int, default=0,
                   help=">0: read and decode in N spawned worker processes "
                        "(one pool a run; workers never touch the card)")
    p.add_argument("--no_shm_workers", action="store_true",
                   help="worker-pool IPC falls back to pickling decoded "
                        "batches instead of shared-memory ring slots "
                        "(control arm; shm is the default)")
    p.add_argument("--no_autotune", action="store_true",
                   help="disable the closed-loop pipeline autotuner (tune/)"
                        " — run the exact fixed-knob configuration; the "
                        "control arm")
    p.add_argument("--autotune_interval_s", type=float, default=1.0,
                   help="autotune controller tick period (decisions also "
                        "respect a policy cooldown between actuations)")
    p.add_argument("--data_echo", type=int, default=1,
                   help=">1: run N train steps per host batch with a fresh "
                        "draw of the flips / MLM mask each echo")
    p.add_argument("--device_cache", action="store_true",
                   help="keep the first epoch's batches on the card and "
                        "replay them in later epochs (no host decode, no "
                        "H2D; flips and MLM masks stay fresh)")
    p.add_argument("--device_cache_gb", type=float, default=8.0,
                   help="fall back to streaming when the projected resident "
                        "size exceeds this")
    bc = p.add_mutually_exclusive_group()
    bc.add_argument("--batch_cache", action="store_true",
                    help="epoch-coherent decoded-batch cache (RAM, then "
                         "disk): later epochs and restarted runs stream "
                         "byte-identical cached batches instead of "
                         "re-reading and re-decoding")
    bc.add_argument("--no_batch_cache", action="store_true",
                    help="the uncached decode path (the default)")
    p.add_argument("--cache_ram_budget_mb", type=int, default=512,
                   help="batch-cache RAM budget (pool-leased pages; LRU "
                        "spill to disk over budget); an autotuner knob")
    p.add_argument("--cache_disk_budget_mb", type=int, default=2048,
                   help="batch-cache disk budget (atomic sha256-verified "
                        "segments; oldest evicted over budget); an "
                        "autotuner knob")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="batch-cache spill directory (default ~/.cache/"
                        "lance_distributed_training_tpu_torch/batch-cache, "
                        "stable across restarts)")
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--no_eval_at_end", action="store_true",
                   help="skip the final eval pass over the train data")
    p.add_argument("--eval_every", type=int, default=0,
                   help=">0: eval every N epochs (val_acc in the epoch's "
                        "history)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--log_grad_norm", action="store_true",
                   help="log the micro-batch gradient's global norm in the "
                        "progress lines (with --grad_accum the update clips "
                        "the accumulated mean, not this)")
    p.add_argument("--run_name", type=str, default=None,
                   help="recorded with the run's config in the first JSONL "
                        "record (default DP-<loader_style>-<sampler>-"
                        "<model>)")
    p.add_argument("--no_wandb", action="store_true",
                   help="accepted for the JAX CLI's sake: the port logs to "
                        "JSONL and stdout only")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="checkpoint root; resumes from the newest intact "
                        "checkpoint when one exists")
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="save every N epochs")
    p.add_argument("--checkpoint_every_steps", type=int, default=0,
                   help=">0: also save every N micro-steps, with the "
                        "data-plane cursor, so a preempted run resumes "
                        "mid-epoch at the exact next batch (absolute steps "
                        "across restarts)")
    p.add_argument("--no_resume", action="store_true",
                   help="ignore existing checkpoints, start fresh")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of epoch steps "
                        "2-12 of the first epoch there")
    p.add_argument("--flash_attention", action="store_true",
                   help="attention through the hand-written CUDA flash "
                        "kernels (the plain version on the CPU)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize transformer blocks (long-context)")
    p.add_argument("--model_parallelism", type=int, default=1,
                   help="tensor-parallel degree (the 'model' mesh axis)")
    p.add_argument("--pipeline_parallelism", type=int, default=1,
                   help="GPipe pipeline stages (the 'pipe' mesh axis)")
    p.add_argument("--pp_microbatches", type=int, default=4,
                   help="microbatches per pipeline round")
    p.add_argument("--fsdp", action="store_true",
                   help="fully shard params + optimizer state over the "
                        "'data' axis (ZeRO-3 equivalent)")
    p.add_argument("--zero", nargs="?", type=int, const=1, default=0,
                   choices=[1, 2], metavar="LEVEL",
                   help="ZeRO gradient/optimizer sharding over the 'data' "
                        "axis, params replicated. Bare --zero (or "
                        "--zero 1) = ZeRO-1: shard only the optimizer "
                        "moments; --zero 2 = ZeRO-2: additionally shard "
                        "the gradient-accumulation buffer (--grad_accum) "
                        "and reduce-scatter the step's gradients into the "
                        "shards. Both are mutually exclusive with --fsdp, "
                        "which already shards everything")
    p.add_argument("--num_experts", type=int, default=0,
                   help=">0: switch-MoE transformer blocks; experts shard "
                        "over the 'model' mesh axis (expert parallelism)")
    p.add_argument("--moe_every", type=int, default=2,
                   help="MoE MLP on every Nth block")
    p.add_argument("--seq_parallelism", type=int, default=1,
                   help="sequence/context-parallel degree (ring attention)")
    dd = p.add_mutually_exclusive_group()
    dd.add_argument("--device_decode", action="store_true",
                    help="split JPEG decode at the entropy boundary: the "
                         "host does only the Huffman half and ships "
                         "coefficient pages; dequantize, IDCT, upsample, "
                         "colour and resize run on the device (K2; "
                         "classification only; raises if the extractor "
                         "cannot be built)")
    dd.add_argument("--no_device_decode", action="store_true",
                    help="the host pixel-decode path (the default)")
    tp = p.add_mutually_exclusive_group()
    tp.add_argument("--token_pack", action="store_true",
                    help="text tasks: variable-length sequences ride the "
                         "loader as values+offsets pages with a "
                         "deterministic first-fit-decreasing pack plan; K3 "
                         "packs them into [rows, pack_len] grids with "
                         "segment and position ids on the device (the eval "
                         "streams the padded arm)")
    tp.add_argument("--no_token_pack", action="store_true",
                    help="the padded token path (the default)")
    p.add_argument("--pack_len", type=int, default=0,
                   help="packed slot-length cap (0 = --seq_len)")
    p.add_argument("--pack_rows_multiple", type=int, default=8,
                   help="packed row-count rounding quantum")
    p.add_argument("--data_service", type=str, default=None,
                   metavar="HOST:PORT",
                   help="stream decoded batches from a running `serve-data` "
                        "service instead of decoding locally (iterable "
                        "columnar path)")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="stream decoded batches from a fleet of `serve-data` "
                        "servers behind this `coordinator` (striped over "
                        "the live members, failover at the resume cursor); "
                        "exclusive with --data_service; not the "
                        "torch.distributed rendezvous (--coordinator_address)")
    p.add_argument("--job_id", type=str, default=None,
                   help="this run's job on a shared service or fleet: its "
                        "resume cursor, fair share and admission there "
                        "(needs --data_service or --coordinator)")
    p.add_argument("--job_priority", type=str, default=None,
                   choices=["inference", "training", "bulk"],
                   help="priority class for --job_id")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="process 0 serves /metrics (Prometheus text) and "
                        "/healthz on this port for the run (0 = ephemeral, "
                        "in the progress log; default off)")
    p.add_argument("--metrics_host", type=str, default="127.0.0.1",
                   help="exporter bind address (default loopback; the "
                        "endpoint has no auth)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default) raises without a card; cpu runs the "
                        "plain versions of the kernels")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (torch.distributed TCP "
                        "rendezvous)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="world size")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")
    xla = p.add_argument_group("JAX runtime flags (raise in the port)")
    xla.add_argument("--backend", type=str, default=None)
    xla.add_argument("--num_cpu_devices", type=int, default=None)
    xla.add_argument("--no_compile_cache", action="store_true")
    xla.add_argument("--compile_cache_dir", type=str, default=None)
    return p


def build_serve_parser() -> argparse.ArgumentParser:
    """``ldt serve-data`` — run a DataService on this (CPU) host. Plan
    parameters (sampler/batch/shard/seed/epoch) come from each trainer's
    handshake; this parser only configures the decode plane."""
    p = argparse.ArgumentParser(
        prog="ldt serve-data",
        description="Serve decoded, plan-ordered training batches over TCP "
                    "(disaggregated input-data service)",
    )
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8476,
                   help="0 = pick an ephemeral port (printed at startup)")
    p.add_argument("--task_type", type=str, default="classification",
                   choices=["classification", "masked_lm", "causal_lm",
                            "contrastive"],
                   help="selects the decode hook; must match the trainer's")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_workers", type=int, default=0,
                   help=">0: decode in N spawned worker processes (size to "
                        "this host's cores)")
    p.add_argument("--no_shm_workers", action="store_true",
                   help="worker-pool IPC falls back to pickling decoded "
                        "batches instead of shared-memory ring slots")
    p.add_argument("--sched_lookahead", type=int, default=0,
                   help=">0: straggler-aware dispatch — reorder worker "
                        "dispatch predicted-heaviest-first within this many "
                        "buffered plan items (needs --num_workers > 0; the "
                        "yielded stream stays in plan order, bit-identical)")
    p.add_argument("--sched_heavy_share", type=int, default=0,
                   help="percent of decode workers reserved as a dedicated "
                        "heavy lane for items predicted far above the "
                        "running mean (0 = single lane)")
    p.add_argument("--no_buffer_pool", action="store_true",
                   help="disable the recycled decode-buffer pool (every "
                        "batch faults a fresh allocation)")
    p.add_argument("--device_decode", action="store_true",
                   help="serve half-decoded JPEG coefficient pages "
                        "(entropy-only host decode) instead of finished "
                        "pixels — trainers must also run --device_decode "
                        "(the HELLO is skew-checked); classification only")
    p.add_argument("--token_pack", action="store_true",
                   help="serve packed variable-length token batches "
                        "(values/offsets pages + pack plan; text tasks) to "
                        "v4 clients that request --token_pack; every other "
                        "peer still streams the bit-identical padded arm")
    p.add_argument("--seq_len", type=int, default=128,
                   help="padded sequence length for text tasks (must match "
                        "the trainer's --seq_len; decode config, like "
                        "--image_size)")
    p.add_argument("--pack_len", type=int, default=0,
                   help="packed slot-length cap (0 = --seq_len)")
    p.add_argument("--pack_rows_multiple", type=int, default=8,
                   help="packed row-count rounding quantum")
    p.add_argument("--batch_cache", action="store_true",
                   help="epoch-coherent decoded-batch cache (tiered "
                        "RAM/disk): a second epoch, a reconnected "
                        "trainer, or a second client streaming the same "
                        "plan is served from cache — no fragment read, "
                        "no decode; content-keyed, stream bit-identical")
    p.add_argument("--cache_ram_budget_mb", type=int, default=512,
                   help="batch-cache RAM ring budget (MiB)")
    p.add_argument("--cache_disk_budget_mb", type=int, default=2048,
                   help="batch-cache disk-spill budget (MiB)")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="batch-cache spill directory (default "
                        "~/.cache/<pkg>/batch-cache)")
    p.add_argument("--queue_depth", type=int, default=4,
                   help="bounded per-client batch queue (backpressure)")
    p.add_argument("--admission_max_jobs", type=int, default=0,
                   help=">0: refuse a NEW job's first session once this "
                        "many non-read-only jobs are admitted (diagnosable "
                        "MSG_ERROR at HELLO; read-only/inference jobs and "
                        "reconnects of admitted jobs always pass); 0 = "
                        "unlimited (pre-r20 behavior)")
    p.add_argument("--admission_max_stall_pct", type=float, default=0.0,
                   help=">0: refuse a NEW job while this server's windowed "
                        "decode stall is above this percentage — admitting "
                        "another tenant would burn the existing jobs' "
                        "stall SLO budget; 0 = no stall gate")
    p.add_argument("--handshake_timeout_s", type=float, default=30.0,
                   help="per-connection HELLO deadline; a peer that "
                        "connects and stays silent is dropped after this "
                        "(0 = wait forever)")
    p.add_argument("--read_retries", type=int, default=3,
                   help="dataset-read attempts (exponential backoff) before "
                        "erroring a client stream")
    p.add_argument("--log_every_s", type=float, default=30.0,
                   help="periodic service-stats line; 0 = off")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve /metrics (Prometheus text: svc_* counters, "
                        "decode/queue-wait histograms) and /healthz (queue "
                        "depths, client liveness) on this port "
                        "(0 = ephemeral, printed at startup; default off)")
    p.add_argument("--metrics_host", type=str, default="127.0.0.1",
                   help="exporter bind address (default loopback; the "
                        "endpoint is unauthenticated — 0.0.0.0 is an "
                        "explicit opt-in)")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="register with this fleet coordinator (`ldt "
                        "coordinator`) and serve as one elastic member: "
                        "heartbeats, shard lease, deregister on stop")
    p.add_argument("--advertise_addr", type=str, default=None,
                   metavar="HOST:PORT",
                   help="the address CLIENTS dial, as registered with the "
                        "coordinator (default: bind host + bound port, "
                        "hostname when binding a wildcard — set explicitly "
                        "behind NAT/containers)")
    p.add_argument("--server_id", type=str, default=None,
                   help="stable fleet identity (default: advertise addr + "
                        "random suffix)")
    p.add_argument("--heartbeat_interval_s", type=float, default=0.0,
                   help="heartbeat period; 0 = use the coordinator's "
                        "advertised interval")
    return p


def build_coordinator_parser() -> argparse.ArgumentParser:
    """``ldt coordinator`` — the fleet control plane: membership,
    generation-numbered shard leases, heartbeat expiry. Carries no data."""
    p = argparse.ArgumentParser(
        prog="ldt coordinator",
        description="Coordinate an elastic fleet of `ldt serve-data` "
                    "servers: registration, heartbeats, shard leases, "
                    "membership resolution for trainers",
    )
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8470,
                   help="0 = pick an ephemeral port (printed at startup)")
    p.add_argument("--heartbeat_interval_s", type=float, default=2.0,
                   help="heartbeat period advertised to members")
    p.add_argument("--lease_ttl_s", type=float, default=6.0,
                   help="heartbeat silence after which a member is expired "
                        "and its lease reassigned (keep >= 2-3 heartbeat "
                        "intervals)")
    p.add_argument("--handshake_timeout_s", type=float, default=10.0,
                   help="per-connection request deadline (a silent peer is "
                        "dropped after this)")
    p.add_argument("--log_every_s", type=float, default=30.0,
                   help="periodic membership line; 0 = off")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve /metrics (fleet_members, "
                        "fleet_lease_generation, fleet_rebalance_ms, ...) "
                        "and /healthz (member table, heartbeat ages) on "
                        "this port (0 = ephemeral; default off)")
    p.add_argument("--metrics_host", type=str, default="127.0.0.1",
                   help="exporter bind address (default loopback)")
    p.add_argument("--scale_up_stall_pct", type=float, default=50.0,
                   help="a member heartbeat reporting windowed stall above "
                        "this flips the fleet recommendation to scale_up "
                        "(/healthz, fleet_scale_recommendation gauge, "
                        "`ldt fleet recommend`)")
    p.add_argument("--scale_down_stall_pct", type=float, default=5.0,
                   help="every member below this (with clients attached, "
                        ">1 members) marks the fleet a drain candidate")
    return p


def build_fleet_parser() -> argparse.ArgumentParser:
    """``ldt fleet`` — operator queries against a running coordinator."""
    p = argparse.ArgumentParser(
        prog="ldt fleet",
        description="Query a running `ldt coordinator`: membership, "
                    "per-member heartbeat pressure, and the scale "
                    "recommendation the autotune fleet half derives",
    )
    p.add_argument("action", choices=["recommend"],
                   help="recommend: print the member table with each "
                        "member's windowed stall pressure and the "
                        "coordinator's scale-up/ok/drain recommendation")
    p.add_argument("--coordinator", type=str, required=True,
                   metavar="HOST:PORT")
    p.add_argument("--timeout_s", type=float, default=10.0)
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw RESOLVE payload as JSON (scripting)")
    return p


def build_jobs_parser() -> argparse.ArgumentParser:
    """``ldt jobs`` — the job plane's operator view: every job the
    coordinator's registry knows, aggregated across member heartbeats."""
    p = argparse.ArgumentParser(
        prog="ldt jobs",
        description="Query a running `ldt coordinator` for the v6 job "
                    "plane: per-job priority class, session count, resume "
                    "cursor, cache hit rate and SLO burn-down",
    )
    p.add_argument("action", choices=["list", "describe"],
                   help="list: one row per registered job; describe: full "
                        "detail (per-objective burn windows) for one job")
    p.add_argument("job_id", nargs="?", default=None,
                   help="the job to describe (describe only)")
    p.add_argument("--coordinator", type=str, required=True,
                   metavar="HOST:PORT")
    p.add_argument("--timeout_s", type=float, default=10.0)
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw per-job rows as JSON (scripting)")
    return p


def _job_row_line(row: dict) -> str:
    rate = row.get("cache_hit_rate")
    return (
        f"  {row.get('job_id')} [{row.get('priority')}] "
        f"sessions {row.get('sessions', 0)} "
        f"cursor {row.get('cursor', -1)} "
        f"batches {row.get('batches_sent', 0)} "
        f"cache_hit_rate {'-' if rate is None else rate}"
    )


def jobs_main(argv=None) -> int:
    """``jobs`` subcommand body. Exit status: 0 on success, 4 when
    ``describe`` names a job the registry does not know (scripting can
    distinguish 'no such tenant' from transport failure)."""
    import json

    args = build_jobs_parser().parse_args(argv)
    if args.action == "describe" and not args.job_id:
        build_jobs_parser().error("describe needs a job_id")
    from .fleet.balancer import resolve_fleet

    payload = resolve_fleet(args.coordinator, timeout_s=args.timeout_s)
    rows = payload.get("jobs") or []
    if args.action == "describe":
        rows = [r for r in rows if r.get("job_id") == args.job_id]
        if not rows:
            print(f"job {args.job_id!r} not registered with "
                  f"{args.coordinator}")
            return 4
    if args.as_json:
        print(json.dumps(rows, indent=2, sort_keys=True))
        return 0
    if args.action == "list":
        print(f"{len(rows)} job(s), generation {payload.get('generation')}")
        for row in rows:
            print(_job_row_line(row))
        return 0
    row = rows[0]
    print(f"job {row.get('job_id')}")
    print(f"  priority:       {row.get('priority')}")
    print(f"  sessions:       {row.get('sessions', 0)}")
    print(f"  resume cursor:  {row.get('cursor', -1)}")
    print(f"  batches sent:   {row.get('batches_sent', 0)}")
    rate = row.get("cache_hit_rate")
    print(f"  cache hit rate: {'-' if rate is None else rate} "
          f"(hit {row.get('cache_hit', 0)} / "
          f"miss {row.get('cache_miss', 0)})")
    burn = row.get("slo_burn") or {}
    for name in sorted(burn):
        windows = burn[name]
        line = " ".join(
            f"{label}={windows[label]}" for label in sorted(windows)
        )
        print(f"  slo {name}: burn {line}")
    return 0


def fleet_main(argv=None) -> int:
    """``fleet`` subcommand body. Exit status encodes the recommendation
    for scripting: 0 = ok/drain_candidate, 3 = scale_up (so an operator
    cron can `ldt fleet recommend … || page`)."""
    import json

    args = build_fleet_parser().parse_args(argv)
    from .fleet.balancer import resolve_fleet

    payload = resolve_fleet(args.coordinator, timeout_s=args.timeout_s)
    recommendation = payload.get("recommendation") or {"action": "ok"}
    if args.as_json:
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(
            f"generation {payload.get('generation')}, "
            f"{payload.get('stripe_count')} members"
        )
        for m in payload.get("members", []):
            pressure = m.get("pressure") or {}
            print(
                f"  {m.get('server_id')} @ {m.get('addr')} "
                f"stripe {m.get('stripe_index')} "
                f"stall {pressure.get('stall_pct', '-')}% "
                f"clients {pressure.get('active_clients', '-')} "
                f"(heartbeat {m.get('heartbeat_age_s')}s ago)"
            )
        for entry in payload.get("stale_members", []) or []:
            # Expired members whose last pressure window is retained (v6):
            # evidence that went stale, not absent — the reason a drain
            # recommendation may be withheld right after a blip.
            pressure = entry.get("pressure") or {}
            print(
                f"  {entry.get('server_id')} EXPIRED "
                f"{entry.get('stale_age_s')}s ago, last stall "
                f"{pressure.get('stall_pct', '-')}%"
            )
        jobs = payload.get("jobs") or []
        if jobs:
            print(f"{len(jobs)} job(s):")
            for row in jobs:
                print(_job_row_line(row))
        queue_wait = payload.get("queue_wait_ms")
        if isinstance(queue_wait, dict):
            # Fleet-wide percentiles merged from the members' heartbeat
            # histograms (protocol v5) — exact, not a mean of p99s.
            print(
                "fleet queue_wait: "
                f"p50 {queue_wait.get('p50_ms')}ms "
                f"p95 {queue_wait.get('p95_ms')}ms "
                f"p99 {queue_wait.get('p99_ms')}ms "
                f"({queue_wait.get('count')} waits, "
                f"{queue_wait.get('members')} members reporting)"
            )
        print(
            f"recommendation: {recommendation.get('action')} — "
            f"{recommendation.get('reason', '')}"
        )
    return 3 if recommendation.get("action") == "scale_up" else 0


def coordinator_main(argv=None) -> dict:
    """``coordinator`` subcommand body — blocks until interrupted."""
    args = build_coordinator_parser().parse_args(argv)
    from .fleet.coordinator import Coordinator, CoordinatorConfig

    coordinator = Coordinator(CoordinatorConfig(
        host=args.host,
        port=args.port,
        heartbeat_interval_s=args.heartbeat_interval_s,
        lease_ttl_s=args.lease_ttl_s,
        handshake_timeout_s=args.handshake_timeout_s,
        log_every_s=args.log_every_s,
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        scale_up_stall_pct=args.scale_up_stall_pct,
        scale_down_stall_pct=args.scale_down_stall_pct,
    ))
    coordinator.serve_forever()
    return coordinator.registry.snapshot()


def serve_main(argv=None) -> dict:
    """``serve-data`` subcommand body — blocks until interrupted."""
    args = build_serve_parser().parse_args(argv)
    from .service.server import DataService, ServeConfig

    service = DataService(ServeConfig(
        dataset_path=args.dataset_path,
        host=args.host,
        port=args.port,
        task_type=args.task_type,
        image_size=args.image_size,
        num_workers=args.num_workers,
        shm_workers=not args.no_shm_workers,
        sched_lookahead=args.sched_lookahead,
        sched_heavy_share=args.sched_heavy_share,
        buffer_pool=not args.no_buffer_pool,
        device_decode=args.device_decode,
        token_pack=args.token_pack,
        seq_len=args.seq_len,
        pack_len=args.pack_len,
        pack_rows_multiple=args.pack_rows_multiple,
        batch_cache=args.batch_cache,
        cache_ram_budget_mb=args.cache_ram_budget_mb,
        cache_disk_budget_mb=args.cache_disk_budget_mb,
        cache_dir=args.cache_dir,
        queue_depth=args.queue_depth,
        admission_max_jobs=args.admission_max_jobs,
        admission_max_stall_pct=args.admission_max_stall_pct,
        handshake_timeout_s=args.handshake_timeout_s,
        read_retries=args.read_retries,
        log_every_s=args.log_every_s,
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        coordinator_addr=args.coordinator,
        advertise_addr=args.advertise_addr,
        server_id=args.server_id,
        heartbeat_interval_s=args.heartbeat_interval_s,
    ))
    service.serve_forever()
    return service.counters.snapshot()


def _trace_main(argv):
    from .obs.spans import trace_main

    return trace_main(argv)


def _costs_main(argv):
    from .obs.costs import costs_main

    return costs_main(argv)


def _protocol_main(argv):
    from .service.goldens import goldens_main

    return goldens_main(argv)


def _check_main(argv):
    from .analysis.cli import check_main

    return check_main(argv)


def _graph_main(argv):
    from .analysis.cli import graph_main

    return graph_main(argv)


# Subcommands of the host processes and the static checker: none loads the
# trainer or touches a card. ``fleet``, ``jobs``, ``protocol``, ``trace``,
# ``costs``, ``check`` and ``graph`` return an exit status.
_SUBCOMMANDS = {
    "serve-data": serve_main,
    "coordinator": coordinator_main,
    "fleet": fleet_main,
    "jobs": jobs_main,
    "protocol": _protocol_main,
    "trace": _trace_main,
    "costs": _costs_main,
    "check": _check_main,
    "graph": _graph_main,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _SUBCOMMANDS:
        return _SUBCOMMANDS[argv[0]](argv[1:])
    if argv and argv[0] == "train":
        argv = argv[1:]
    args = vars(build_parser().parse_args(argv))
    for name in _XLA_FLAGS:
        if args.pop(name) not in (None, False):
            raise NotImplementedError(
                f"--{name} configures the JAX package's XLA runtime; the "
                "PyTorch port picks its device with --device {cuda,cpu} and "
                "has no XLA compile cache")
    args["zero_opt"] = args.pop("zero")
    args["data_service_addr"] = args.pop("data_service")
    args["coordinator_addr"] = args.pop("coordinator")
    args["resume"] = not args.pop("no_resume")
    args["augment"] = not args.pop("no_augment")
    args["eval_at_end"] = not args.pop("no_eval_at_end")
    args["global_batch"] = not args.pop("no_global_batch")
    args["buffer_pool"] = not args.pop("no_buffer_pool")
    args["shm_workers"] = not args.pop("no_shm_workers")
    args["autotune"] = not args.pop("no_autotune")
    no_batch_cache = args.pop("no_batch_cache")
    args["batch_cache"] = args["batch_cache"] and not no_batch_cache
    no_device_decode = args.pop("no_device_decode")
    args["device_decode"] = args["device_decode"] and not no_device_decode
    no_token_pack = args.pop("no_token_pack")
    args["token_pack"] = args["token_pack"] and not no_token_pack
    from .trainer import TrainConfig

    # ``train`` through the module, so that a caller may replace it.
    return getattr(sys.modules[__name__], "train")(TrainConfig(**args))


if __name__ == "__main__":
    _result = main()
    if isinstance(_result, int) and _result != 0:
        raise SystemExit(_result)
