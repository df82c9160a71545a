"""Models and tasks."""

from .convert import (
    load_flax_params,
    load_flax_resnet,
    resnet_state_dict_from_flax,
    torch_state_dict_from_flax,
)
from .registry import get_model_and_loss
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152
from .tasks import (
    Task,
    causal_lm_task,
    classification_task,
    get_task,
    masked_lm_task,
)
from .transformer import (
    TransformerEncoder,
    bert_base,
    bert_small,
    gpt_base,
    gpt_small,
)

__all__ = ["ResNet", "Task", "TransformerEncoder", "bert_base", "bert_small",
           "causal_lm_task", "classification_task", "get_model_and_loss", "get_task",
           "gpt_base", "gpt_small",
           "load_flax_params", "load_flax_resnet", "masked_lm_task",
           "resnet101", "resnet152", "resnet18", "resnet34", "resnet50",
           "resnet_state_dict_from_flax", "torch_state_dict_from_flax"]
