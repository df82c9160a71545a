"""CLI — the ``train`` subcommand of the port.

Counterpart of ``lance_distributed_training_tpu/cli.py`` for the ported
paths, image classification (its defaults: ResNet-50, 224 px, 101 classes,
global batch 512, SGD lr 0.05 momentum 0.9, flips, eval at the end) and
masked-LM text, ``--device_decode`` (JPEG decode split at the entropy
boundary, K2 on the device), plus ``--device {cuda,cpu}`` (default
``cuda``, which raises when no card is present). Any other flag of the JAX CLI raises "not
yet ported"; so do the other subcommands and task types. Usage::

    python -m lance_distributed_training_tpu_torch.cli train \\
        --dataset_path /data/food101 --max_steps 20 [--device_decode]
    python -m lance_distributed_training_tpu_torch.cli train \\
        --dataset_path /data/c4_tokens --task_type masked_lm \\
        --model_name bert_base --seq_len 512 --flash_attention \\
        --batch_size 32 --optimizer adamw --lr 1e-4 --max_steps 20

Data parallel over N processes: run one per process with
``--coordinator_address host:port --num_processes N --process_id i``.
"""

from __future__ import annotations

import argparse
import sys

from .trainer import TrainConfig, train

__all__ = ["build_parser", "main"]


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
                            "masked-LM)")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--task_type", type=str, default="classification",
                   choices=["classification", "masked_lm", "causal_lm",
                            "contrastive"],
                   help="classification and masked_lm are ported; the "
                        "others raise")
    p.add_argument("--num_classes", type=int, default=101)
    p.add_argument("--sampler_type", type=str, default="batch",
                   choices=["batch", "fragment", "full", "sharded_batch",
                            "sharded_fragment", "full_scan"])
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
    p.add_argument("--no_ddp", action="store_true",
                   help="single process even with --coordinator_address")
    p.add_argument("--model_name", type=str, default=None,
                   choices=["resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152", "bert_base", "bert_small"],
                   help="default per task: resnet50 / bert_base")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--no_eval_at_end", action="store_true",
                   help="skip the final eval pass over the train data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--flash_attention", action="store_true",
                   help="attention through the hand-written CUDA flash "
                        "kernels (the plain version on the CPU)")
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
    args["augment"] = not args.pop("no_augment")
    args["eval_at_end"] = not args.pop("no_eval_at_end")
    no_device_decode = args.pop("no_device_decode")
    args["device_decode"] = args["device_decode"] and not no_device_decode
    return train(TrainConfig(**args))


if __name__ == "__main__":
    main()
