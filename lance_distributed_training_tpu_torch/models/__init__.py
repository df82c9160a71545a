"""Models and tasks."""

from .clip import CLIP, clip_contrastive_loss, clip_resnet50_bert, clip_tiny
from .convert import (
    clip_state_dict_from_flax,
    load_flax_clip,
    load_flax_params,
    load_flax_resnet,
    load_flax_vit,
    resnet_state_dict_from_flax,
    torch_state_dict_from_flax,
    vit_state_dict_from_flax,
)
from .moe import MoEMLP
from .registry import get_model_and_loss
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152
from .tasks import (
    Task,
    causal_lm_task,
    classification_task,
    contrastive_task,
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
from .vit import ViT, vit_base, vit_small, vit_tiny

__all__ = ["CLIP", "MoEMLP", "ResNet", "Task", "TransformerEncoder", "ViT",
           "bert_base", "bert_small", "causal_lm_task", "classification_task",
           "clip_contrastive_loss", "clip_resnet50_bert",
           "clip_state_dict_from_flax", "clip_tiny", "contrastive_task",
           "get_model_and_loss", "get_task", "gpt_base", "gpt_small",
           "load_flax_clip", "load_flax_params", "load_flax_resnet",
           "load_flax_vit", "masked_lm_task", "resnet101", "resnet152",
           "resnet18", "resnet34", "resnet50", "resnet_state_dict_from_flax",
           "torch_state_dict_from_flax", "vit_base", "vit_small", "vit_tiny",
           "vit_state_dict_from_flax"]
