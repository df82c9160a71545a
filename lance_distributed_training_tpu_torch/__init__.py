"""PyTorch/CUDA port of ``lance_distributed_training_tpu``.

A second package beside the JAX one, which stays the reference. It mirrors
the JAX package's module layout and imports nothing of it (nor JAX): it keeps
its own copies of the host code it needs. The ported paths are image
classification (the ResNet family on JPEG datasets, host-decoded by a
native libjpeg batch decoder or PIL, normalised and flipped on the card by
the hand-written K1 kernel, ``ops/csrc/image.cu``; data parallel over
``torch.distributed``) and masked-LM training of the BERT family through
hand-written Hopper flash-attention kernels (``ops/csrc/flash_attn.cu``).
Entry points run on CUDA unless the caller asks for the CPU
(``TrainConfig.device`` / ``--device cpu``).
"""

from .data import (
    Dataset,
    create_synthetic_classification_dataset,
    create_text_token_dataset,
    decoder_for_task,
    make_eval_pipeline,
    make_train_pipeline,
    write_dataset,
)
from .models import (
    ResNet,
    TransformerEncoder,
    get_model_and_loss,
    get_task,
    load_flax_params,
    load_flax_resnet,
)
from .ops import LAUNCHES, flash_attention, make_flash_attention, normalize_flip
from .trainer import TrainConfig, evaluate, make_eval_step, train

__all__ = [
    "Dataset",
    "LAUNCHES",
    "ResNet",
    "TrainConfig",
    "TransformerEncoder",
    "create_synthetic_classification_dataset",
    "create_text_token_dataset",
    "decoder_for_task",
    "evaluate",
    "flash_attention",
    "get_model_and_loss",
    "get_task",
    "load_flax_params",
    "load_flax_resnet",
    "make_eval_pipeline",
    "make_eval_step",
    "make_flash_attention",
    "make_train_pipeline",
    "normalize_flip",
    "train",
    "write_dataset",
]
