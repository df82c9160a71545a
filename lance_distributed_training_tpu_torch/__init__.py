"""PyTorch/CUDA port of ``lance_distributed_training_tpu``.

A second package beside the JAX one, which stays the reference. It mirrors
the JAX package's module layout and imports nothing of it (nor JAX): it keeps
its own copies of the host code it needs. The ported paths are image
classification (the ResNet family and the ViTs on JPEG datasets,
host-decoded by a native libjpeg batch decoder or PIL, normalised and
flipped on the card by the hand-written K1 kernel, ``ops/csrc/image.cu``;
data parallel over ``torch.distributed``), masked-LM and causal-LM training
of the BERT and GPT families (with switch-MoE blocks on request) through
hand-written Hopper flash-attention kernels (``ops/csrc/flash_attn.cu``),
and CLIP contrastive training on image-caption rows.
Entry points run on CUDA unless the caller asks for the CPU
(``TrainConfig.device`` / ``--device cpu``).

The names below load their modules on first use: a decode worker process
imports the data plane it needs and never torch's CUDA libraries.
"""

import importlib
import os
import sys

__version__ = "0.1.0"


def _install_lock_sanitizer() -> None:
    """Under ``LDT_LOCK_SANITIZER=1``, install the lock-order shim
    (``utils/lockorder.py``) before any module of the port makes a lock.
    The module is loaded from its file, not through ``utils/__init__``
    (which imports modules that make locks), under its dotted name, so a
    later import shares its recorder."""
    name = f"{__name__}.utils.lockorder"
    module = sys.modules.get(name)
    if module is None:
        import importlib.util

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "utils", "lockorder.py")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    module.install_from_env()


if os.environ.get("LDT_LOCK_SANITIZER") == "1":
    _install_lock_sanitizer()

# Name -> the submodule that defines it. Imported on first use, so that a
# process that needs one plane (a decode worker: the format, the
# decoders, the shm ring) does not import torch and the trainer with it.
_EXPORTS = {
    "data": (
        "Dataset", "create_synthetic_classification_dataset",
        "create_text_token_dataset", "decoder_for_task", "make_eval_pipeline",
        "make_train_pipeline", "write_dataset",
    ),
    "models": (
        "CLIP", "ResNet", "TransformerEncoder", "ViT", "get_model_and_loss",
        "get_task", "load_flax_params", "load_flax_resnet",
    ),
    "ops": (
        "LAUNCHES", "flash_attention", "make_flash_attention",
        "normalize_flip",
    ),
    "trainer": (
        "TrainConfig", "evaluate", "make_eval_step", "train",
    ),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_WHERE))
