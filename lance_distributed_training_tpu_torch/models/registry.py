"""Task registry — ``task_type`` string → (model, loss_fn, eval_fn).

Counterpart of ``lance_distributed_training_tpu/models/registry.py``: only
``"classification"`` is registered here (a ResNet or a ViT by
``model_name``) and any other task type raises ``ValueError``, with the
same message; the other tasks live behind :func:`~.tasks.get_task`.
"""

from __future__ import annotations

from typing import Callable

from .tasks import get_task

__all__ = ["get_model_and_loss"]


def get_model_and_loss(task_type: str, num_classes: int,
                       model_name: str = "resnet50", image_size: int = 224
                       ) -> tuple[object, Callable, Callable]:
    """``(model, loss_fn(logits, batch), eval_fn(logits, batch))``: mean
    cross-entropy and per-example top-1 correctness."""
    if task_type != "classification":
        raise ValueError(f"Invalid task type: {task_type}")
    task = get_task("classification", num_classes=num_classes,
                    model_name=model_name, image_size=image_size)
    return task.model, task.loss, task.metric
