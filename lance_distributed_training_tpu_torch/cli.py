"""CLI — the ``train`` subcommand of the port.

Counterpart of ``lance_distributed_training_tpu/cli.py`` for the ported
paths, image classification (its defaults: ResNet-50, 224 px, 101 classes,
global batch 512, SGD lr 0.05 momentum 0.9, flips, eval at the end),
masked-LM and causal-LM text with ``--token_pack`` (ragged pages, an FFD
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
The JAX runtime's flags (``--backend``, ``--num_cpu_devices``,
``--no_compile_cache``, ``--compile_cache_dir``) raise: the port picks its
device with ``--device`` and has no XLA compile cache. Any other flag of
the JAX CLI raises "not yet ported"; so do the other subcommands and task
types. Usage::

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

Data parallel over N processes: run one per process with
``--coordinator_address host:port --num_processes N --process_id i``.
``--seq_parallelism K`` (masked-LM) runs attention as a ring over K
sequence blocks (K5): in the one process, or over K processes a ring when
N > 1 (N divisible by K)::

    python -m lance_distributed_training_tpu_torch.cli train \
        --dataset_path /data/c4_tokens --task_type masked_lm \
        --model_name bert_base --seq_len 512 --batch_size 32 \
        --seq_parallelism 4 --optimizer adamw --lr 1e-4 --max_steps 20
"""

from __future__ import annotations

import argparse
import sys

from .trainer import TrainConfig, train

__all__ = ["build_parser", "main"]

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
                            "masked-LM, causal-LM)")
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
                            "contrastive"],
                   help="classification, masked_lm and causal_lm are "
                        "ported; contrastive raises")
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
                            "resnet152", "bert_base", "bert_small",
                            "gpt_base", "gpt_small"],
                   help="default per task: resnet50 / bert_base / gpt_base")
    p.add_argument("--pretrained", type=str, default=None,
                   help="path to a torch.save'd torchvision ResNet "
                        "state_dict: fine-tune from its backbone weights "
                        "(the reference's pretrained-ResNet50 task shape)")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=None)
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


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        argv = argv[1:]
    elif argv and not argv[0].startswith("-"):
        raise NotImplementedError(
            f"subcommand {argv[0]!r} is not yet ported (train only)"
        )
    args = vars(build_parser().parse_args(argv))
    for name in _XLA_FLAGS:
        if args.pop(name) not in (None, False):
            raise NotImplementedError(
                f"--{name} configures the JAX package's XLA runtime; the "
                "PyTorch port picks its device with --device {cuda,cpu} and "
                "has no XLA compile cache")
    args["resume"] = not args.pop("no_resume")
    args["augment"] = not args.pop("no_augment")
    args["eval_at_end"] = not args.pop("no_eval_at_end")
    args["global_batch"] = not args.pop("no_global_batch")
    args["buffer_pool"] = not args.pop("no_buffer_pool")
    no_device_decode = args.pop("no_device_decode")
    args["device_decode"] = args["device_decode"] and not no_device_decode
    no_token_pack = args.pop("no_token_pack")
    args["token_pack"] = args["token_pack"] and not no_token_pack
    return train(TrainConfig(**args))


if __name__ == "__main__":
    main()
