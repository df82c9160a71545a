"""Task abstraction: model + forward + loss + metric as one unit.

Counterpart of ``lance_distributed_training_tpu/models/tasks.py``:
``classification`` (the ResNets and the ViTs), ``masked_lm`` and
``causal_lm`` (with switch-MoE blocks when ``num_experts > 0``: in
training their load-balance terms, weighted 0.01, join the loss) and
``contrastive`` (CLIP), and ``masked_lm_pp``, the masked-LM whose
encoder stack runs through the GPipe pipeline
(:class:`PipelinedMaskedLM`, ``parallel/pipeline_parallel.py``). The text
tasks take packed batches too:
``segment_ids`` and ``position_ids`` (from K3, :mod:`..ops.token_device`)
go to the model when the batch carries them; a contrastive batch's
captions may come bucketed by K3 (one caption a row). The JAX tasks draw
their random masks (the MLM mask, the per-image flip) with ``jax.random``;
here ``forward`` takes the draw explicitly (``mlm_mask``, ``flip_mask``)
or makes it from a ``torch.Generator`` (the two generators give different
bits, so parity tests pass the draw in). As JAX draws each mask over the
global batch from one key, the trainer draws it over the global batch
from one generator, the same on every process, and each data share takes
its rows (:func:`draw_mlm_mask`'s ``share``).

Across processes the text losses are the JAX package's weighted mean over
the GLOBAL batch: with ``loss_group`` each process divides its weighted
sum by the group's total weight (all-reduced, no gradient) and scales by
the group's size, so that DDP's mean of the per-process gradients is the
gradient of the global loss, and the mean of the per-process losses is
that loss. The MoE layers route over the same group's global batch and
the contrastive loss gathers both embeddings over it (``models/moe.py``,
``models/clip.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.image import normalize_flip
from .clip import (
    clip_contrastive_loss,
    clip_resnet50_bert,
    clip_tiny,
    retrieval_top1,
)
from .moe import moe_aux_loss, set_moe_group
from .resnet import RESNETS
from ..parallel import comm
from .transformer import (EncoderBlock, _Dense, bert_base, bert_small,
                          gpt_base, gpt_small, vocab_argmax,
                          vocab_cross_entropy)
from .vit import vit_base, vit_small, vit_tiny

__all__ = ["Task", "get_task", "classification_task", "masked_lm_task",
           "causal_lm_task", "contrastive_task", "draw_mlm_mask",
           "eval_mlm_mask",
           "pipelined_masked_lm_task", "PipelinedMaskedLM", "TASK_REGISTRY"]

TASK_REGISTRY = ("classification", "masked_lm", "causal_lm", "contrastive")
AUX_LOSS_WEIGHT = 0.01  # the MoE load-balance term's weight in the loss


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    model: Any  # torch.nn.Module
    forward: Callable  # (batch, train, generator=None, <task's mask>=None) -> outputs
    loss: Callable  # (outputs, batch) -> scalar tensor
    metric: Callable  # (outputs, batch) -> per-example tensor
    metric_name: str = "accuracy"
    # (module) -> the same task running ``module``, e.g. a DDP wrapper
    with_model: Optional[Callable] = None


def _images(batch, train: bool, augment: bool,
            generator: Optional[torch.Generator],
            flip_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K1 on the batch's uint8 images: normalised and, in training with
    ``augment``, flipped by ``flip_mask`` (drawn from ``generator`` with
    p = 0.5 when not given); the channels_last NCHW view of the bf16
    NHWC output."""
    images = batch["image"]
    if not (train and augment):
        flip_mask = None
    elif flip_mask is None and generator is not None:
        flip_mask = torch.rand(images.shape[0], generator=generator,
                               device=images.device) < 0.5
    if flip_mask is not None:
        flip_mask = flip_mask.to(images.device)
    return normalize_flip(images, flip_mask).permute(0, 3, 1, 2)


def classification_task(model, augment: bool = True) -> Task:
    """Image classification over ``{image: u8 [B, H, W, 3], label}``
    batches: K1 normalises (and in training flips) the images on the
    device, the model (a ResNet or a ViT) maps them to f32 logits.
    ``forward`` puts the model in training or eval mode to match
    ``train``; ``flip_mask`` (``[B]``) is the per-image flip draw, made
    from ``generator`` with p = 0.5 when not given."""

    def forward(batch, train: bool, generator: Optional[torch.Generator] = None,
                flip_mask: Optional[torch.Tensor] = None):
        x = _images(batch, train, augment, generator, flip_mask)
        model.train(train)
        return model(x)

    def loss(logits, batch):
        return F.cross_entropy(logits.float(), batch["label"].long())

    def metric(logits, batch):
        return (logits.argmax(-1) == batch["label"].long()).float()

    return Task("classification", model, forward, loss, metric,
                with_model=lambda module: classification_task(module, augment))


VITS = {"vit_tiny": vit_tiny, "vit_small": vit_small, "vit_base": vit_base}


def _classification_task(num_classes: int, model_name: str, augment: bool,
                         device=None,
                         generator: Optional[torch.Generator] = None,
                         image_size: int = 224, **model_kwargs) -> Task:
    """A ResNet or ViT classification task; the model is built on
    ``device`` and initialised from ``generator``. A ViT is built for
    ``image_size`` (its position table); the ResNets take any size."""
    registry = {**RESNETS, **VITS}
    ctor = registry.get(model_name)
    if ctor is None:
        raise ValueError(f"Invalid model name: {model_name} "
                         f"(have {sorted(registry)})")
    if model_name in VITS:
        model_kwargs["image_size"] = image_size
    model = ctor(num_classes=num_classes, device=device, generator=generator,
                 **model_kwargs)
    return classification_task(model, augment)


MASK_PROB = 0.15  # share of valid positions masked per training step
MASK_ID = 1  # the token that replaces a masked position


def _weighted_mean(raw, w, group) -> torch.Tensor:
    """``(raw·w).sum() / max(Σw, 1)`` over the global batch: without a
    group, this process's; with one, the sums of all its processes (see the
    module's docstring)."""
    total, scale = w.sum(), 1
    if group is not None:
        total = comm.all_reduce(total.detach(), group)
        scale = dist.get_world_size(group)
    return (raw * w).sum() / torch.clamp(total, min=1.0) * scale


def draw_mlm_mask(batch, generator: torch.Generator,
                  share: tuple = (0, 1)) -> torch.Tensor:
    """The training MLM mask of a batch: each valid position with
    probability ``MASK_PROB``, from ``generator``. ``share = (index,
    count)`` names the batch as data share ``index`` of ``count`` equal
    shares of the global batch: the draw is over the global batch's shape
    (the shares' rows stacked in order, as JAX assembles the global array
    from each process's rows) and the share takes its rows of it, so that
    every process draws the one global mask that JAX's ``bernoulli`` over
    ``ids.shape`` draws from one key."""
    ids = batch["input_ids"]
    index, count = share
    rows = ids.shape[0]
    draw = torch.rand((rows * count,) + tuple(ids.shape[1:]),
                      generator=generator, device=ids.device)
    draw = draw[index * rows:(index + 1) * rows]
    return (draw < MASK_PROB) & (batch["attention_mask"] > 0)


def eval_mlm_mask(batch) -> torch.Tensor:
    """The eval MLM mask of a batch: every ~1/MASK_PROB-th column of the
    valid positions, deterministically."""
    ids = batch["input_ids"]
    stride = max(int(round(1.0 / MASK_PROB)), 1)
    positions = torch.arange(ids.shape[1], device=ids.device)
    return ((positions % stride) == 0)[None, :] & (batch["attention_mask"] > 0)


def _with_aux(loss: torch.Tensor, model) -> torch.Tensor:
    """The loss plus the weighted load-balance terms of ``model``'s MoE
    layers from their last forward, in training only (the JAX task collects
    the sown terms in training only)."""
    aux = moe_aux_loss(model) if model.training else None
    return loss if aux is None else loss + AUX_LOSS_WEIGHT * aux


def masked_lm_task(model, loss_group=None) -> Task:
    """BERT masked-LM over ``{input_ids, attention_mask}`` batches (plus
    ``segment_ids``/``position_ids`` when packed). Masked positions are
    replaced by ``MASK_ID`` and are the loss targets. ``loss_group`` makes
    the loss the global batch's (and routes the MoE layers over it).
    ``forward`` returns ``(logits, mlm_mask)``; in training the MoE
    layers' load-balance terms join the loss."""
    set_moe_group(model, loss_group)

    def forward(batch, train: bool, generator: Optional[torch.Generator] = None,
                mlm_mask: Optional[torch.Tensor] = None):
        ids = batch["input_ids"].long()
        if mlm_mask is None:
            if train and generator is not None:
                mlm_mask = draw_mlm_mask(batch, generator)
            else:
                mlm_mask = eval_mlm_mask(batch)
        mlm_mask = mlm_mask.to(device=ids.device, dtype=torch.bool)
        corrupted = torch.where(mlm_mask, torch.full_like(ids, MASK_ID), ids)
        model.train(train)
        logits = model(corrupted, batch["attention_mask"],
                       segment_ids=batch.get("segment_ids"),
                       position_ids=batch.get("position_ids"))
        return logits, mlm_mask

    def loss(outputs, batch):
        logits, mlm_mask = outputs
        targets = batch["input_ids"].long()
        # Under tensor parallelism the logits are this rank's vocabulary
        # block: the cross-entropy reduces over the blocks, no rank holds
        # the whole [B, S, vocab] tensor.
        raw = vocab_cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            targets.reshape(-1), model)
        return _with_aux(
            _weighted_mean(raw, mlm_mask.reshape(-1).float(), loss_group),
            model)

    def metric(outputs, batch, seq_group=None):
        # On a ring of processes (``seq_group``) each holds a sequence
        # block of the rows: the per-row sums are the ring's.
        logits, mlm_mask = outputs
        hit = (vocab_argmax(logits, model)
               == batch["input_ids"].long()).float()
        w = mlm_mask.float()
        hits, count = (hit * w).sum(-1), w.sum(-1)
        if seq_group is not None:
            hits, count = comm.all_reduce(torch.stack([hits, count]),
                                          seq_group).unbind()
        return hits / torch.clamp(count, min=1.0)

    return Task("masked_lm", model, forward, loss, metric,
                metric_name="masked_token_accuracy",
                with_model=lambda module: masked_lm_task(module, loss_group))


def _masked_lm_task(vocab_size: Optional[int], model_name: str, seq_len: int,
                    attention_fn: Optional[Callable] = None, device=None,
                    generator: Optional[torch.Generator] = None,
                    loss_group=None, num_experts: int = 0,
                    moe_every: int = 2, remat: bool = False) -> Task:
    """A ``bert_base`` or ``bert_small`` masked-LM task (switch-MoE on every
    ``moe_every``-th block with ``num_experts > 0``, each block
    rematerialized with ``remat``); the model is built on ``device`` and
    initialised from ``generator``."""
    ctor = {"bert_base": bert_base, "bert_small": bert_small}.get(model_name)
    if ctor is None:
        raise ValueError(f"Invalid model name: {model_name} "
                         "(have ['bert_base', 'bert_small'])")
    model = ctor(vocab_size=vocab_size or 30522, max_len=seq_len,
                 attention_fn=attention_fn, remat=remat,
                 num_experts=num_experts, moe_every=moe_every, device=device,
                 generator=generator)
    return masked_lm_task(model, loss_group)


# The pipelined encoder's widths: (hidden, layers, heads, mlp_dim).
_BERT_DIMS = {"bert_base": (768, 12, 12, 3072), "bert_small": (256, 4, 4, 1024)}


class PipelinedMaskedLM(torch.nn.Module):
    """The masked-LM of JAX ``_pipelined_masked_lm_task``: ``tok_embed
    [vocab, H]`` and ``pos_embed [seq_len, H]`` (both ``N(0, 0.02)``), the
    ``layers`` encoder blocks with their parameters stacked ``[L, ...]``
    under ``blocks`` (each block initialised as an :class:`EncoderBlock`),
    a final LayerNorm (``ln_scale``, ``ln_bias``, statistics in f32,
    epsilon 1e-6) and the head tied to ``tok_embed`` in f32.

    ``forward(input_ids)`` embeds, runs the blocks through
    :func:`..parallel.pipeline_parallel.pipeline_apply` in
    ``n_microbatches`` microbatches, with attention unmasked (the task is
    meant for packed rows; the loss still respects the attention mask),
    and returns f32 logits. Outside a pipeline (``pipe_ranks`` unset) the
    one stage is this model's, which applies every block in turn;
    ``parallel/layout.shard_model_`` keeps a stage's slice of
    ``blocks`` and sets ``pipe_group``, ``pipe_ranks``, ``stage`` and
    ``data``."""

    def __init__(self, vocab_size: int, hidden: int, layers: int, heads: int,
                 mlp_dim: int, seq_len: int, n_microbatches: int = 4,
                 dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.n_microbatches = n_microbatches
        self.pipe_group, self.pipe_ranks, self.stage, self.data = (
            None, None, 0, 1)
        blocks = [EncoderBlock(hidden, heads, mlp_dim, dtype)
                  for _ in range(layers)]
        for block in blocks:
            for module in block.modules():
                if isinstance(module, _Dense):
                    module.reset_from(generator)
        # One block's module tree holds the stacked parameters; its
        # forward runs through functional_call on one layer's slice.
        self.blocks = blocks[0]
        with torch.no_grad():
            for name, _ in list(blocks[0].named_parameters()):
                stacked = torch.stack([b.get_parameter(name) for b in blocks])
                owner, leaf = _owner(self.blocks, name)
                setattr(owner, leaf, torch.nn.Parameter(stacked))
        self.tok_embed = torch.nn.Parameter(torch.empty(vocab_size, hidden))
        self.pos_embed = torch.nn.Parameter(torch.empty(seq_len, hidden))
        with torch.no_grad():
            self.tok_embed.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.ln_scale = torch.nn.Parameter(torch.ones(hidden))
        self.ln_bias = torch.nn.Parameter(torch.zeros(hidden))
        if device is not None:
            self.to(device)

    def _stage(self, stacked: dict, h: torch.Tensor) -> torch.Tensor:
        from torch.func import functional_call

        for i in range(len(next(iter(stacked.values())))):
            h = functional_call(self.blocks,
                                {n: v[i] for n, v in stacked.items()},
                                (h, None))
        return h

    def forward(self, input_ids, attention_mask=None, segment_ids=None,
                position_ids=None):
        from ..parallel.pipeline_parallel import pipeline_apply

        s = input_ids.shape[1]
        x = F.embedding(input_ids, self.tok_embed).to(self.dtype)
        x = x + self.pos_embed[None, :s].to(self.dtype)
        stacked = {n: p.unbind(0) for n, p in self.blocks.named_parameters()}
        x = pipeline_apply(self._stage, stacked, x, self.n_microbatches,
                           pipe_group=self.pipe_group,
                           pipe_ranks=self.pipe_ranks, stage=self.stage,
                           data=self.data)
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
        x32 = (x32 - mean) / torch.sqrt(var + 1e-6) * self.ln_scale \
            + self.ln_bias
        return x32 @ self.tok_embed.t()


def _owner(module: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def pipelined_masked_lm_task(model: PipelinedMaskedLM, loss_group=None) -> Task:
    """Masked-LM over :class:`PipelinedMaskedLM` (task ``masked_lm_pp``):
    the masked-LM task's masking, loss (no load-balance term) and metric."""
    base = masked_lm_task(model, loss_group)
    return dataclasses.replace(
        base, name="masked_lm_pp",
        with_model=lambda module: pipelined_masked_lm_task(module,
                                                           loss_group))


def _pipelined_masked_lm_task(vocab_size: Optional[int], model_name: str,
                              seq_len: int, pipeline_parallelism: int,
                              n_microbatches: int, device=None,
                              generator: Optional[torch.Generator] = None,
                              loss_group=None) -> Task:
    if model_name not in _BERT_DIMS:
        raise ValueError(f"Invalid model name: {model_name} "
                         f"(have {sorted(_BERT_DIMS)})")
    hidden, layers, heads, mlp_dim = _BERT_DIMS[model_name]
    if layers % pipeline_parallelism:
        raise ValueError(f"{layers} layers not divisible by "
                         f"pipe={pipeline_parallelism}")
    model = PipelinedMaskedLM(vocab_size or 30522, hidden, layers, heads,
                              mlp_dim, seq_len, n_microbatches,
                              device=device, generator=generator)
    return pipelined_masked_lm_task(model, loss_group)


def causal_lm_task(model, loss_group=None) -> Task:
    """Next-token prediction (GPT family) over ``{input_ids,
    attention_mask}`` batches, plus ``segment_ids``/``position_ids`` when
    packed. Position t predicts token t + 1, weighted by the target's
    validity; in packed rows a position whose target lies in another
    sequence (a junction) is weighted out. ``loss_group`` makes the loss
    the global batch's (and routes the MoE layers over it); in training
    the MoE layers' load-balance terms join the loss. ``forward`` returns
    the logits."""
    set_moe_group(model, loss_group)

    def forward(batch, train: bool, generator: Optional[torch.Generator] = None):
        ids = batch["input_ids"].long()
        model.train(train)
        return model(ids, batch["attention_mask"],
                     segment_ids=batch.get("segment_ids"),
                     position_ids=batch.get("position_ids"))

    def _targets(batch):
        """Each position's target (the next token) and weight, ``[B, S]``:
        the last position of a row has no target and weighs 0."""
        ids = batch["input_ids"].long()
        targets = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], 1)
        w = batch["attention_mask"][:, 1:].float()
        seg = batch.get("segment_ids")
        if seg is not None:
            w = w * (seg[:, 1:] == seg[:, :-1]).float()
        return targets, torch.cat([w, torch.zeros_like(w[:, :1])], 1)

    def loss(logits, batch):
        # The full [B, S, V] logits stay a view: slicing off the last
        # position would copy them.
        targets, w = _targets(batch)
        raw = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                              targets.reshape(-1), reduction="none")
        return _with_aux(_weighted_mean(raw, w.reshape(-1), loss_group),
                         model)

    def metric(logits, batch):
        targets, w = _targets(batch)
        hit = (logits.argmax(-1) == targets).float()
        return (hit * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)

    return Task("causal_lm", model, forward, loss, metric,
                metric_name="next_token_accuracy",
                with_model=lambda module: causal_lm_task(module, loss_group))


def _causal_lm_task(vocab_size: Optional[int], model_name: str, seq_len: int,
                    attention_fn: Optional[Callable] = None, device=None,
                    generator: Optional[torch.Generator] = None,
                    loss_group=None, num_experts: int = 0,
                    moe_every: int = 2, remat: bool = False) -> Task:
    """A ``gpt_base`` (GPT-2 124M's shape) or ``gpt_small`` causal-LM task,
    vocabulary 50257 by default (switch-MoE on every ``moe_every``-th
    block with ``num_experts > 0``, each block rematerialized with
    ``remat``); the model is built on ``device`` and initialised from
    ``generator``. An ``attention_fn`` must bind its own
    causality (``make_flash_attention(causal=True)``)."""
    ctor = {"gpt_base": gpt_base, "gpt_small": gpt_small}.get(model_name)
    if ctor is None:
        raise ValueError(f"Invalid model name: {model_name} "
                         "(have ['gpt_base', 'gpt_small'])")
    model = ctor(vocab_size=vocab_size or 50257, max_len=seq_len,
                 attention_fn=attention_fn, remat=remat,
                 num_experts=num_experts, moe_every=moe_every, device=device,
                 generator=generator)
    return causal_lm_task(model, loss_group)


def contrastive_task(model, augment: bool = True, loss_group=None) -> Task:
    """CLIP contrastive over ``{image: u8 [B, H, W, 3], input_ids,
    attention_mask}`` batches: K1 normalises (and in training flips) the
    images as for classification, the model gives both unit embeddings
    and the scale; the loss is :func:`~.clip.clip_contrastive_loss` over
    ``loss_group``'s global batch, the metric ``retrieval_top1`` (per
    image, over the global batch's captions: under ``loss_group`` both
    embeddings are gathered first and each process keeps its own
    images' hits)."""

    def forward(batch, train: bool, generator: Optional[torch.Generator] = None,
                flip_mask: Optional[torch.Tensor] = None):
        x = _images(batch, train, augment, generator, flip_mask)
        model.train(train)
        return model(x, batch["input_ids"].long(), batch["attention_mask"])

    def loss(outputs, batch):
        return clip_contrastive_loss(*outputs, group=loss_group)

    def metric(outputs, batch):
        img_emb, txt_emb, _scale = outputs
        if loss_group is None:
            return retrieval_top1(img_emb, txt_emb)
        rows = img_emb.shape[0]
        lo = dist.get_rank(loss_group) * rows
        hits = retrieval_top1(comm.all_gather(img_emb, loss_group),
                              comm.all_gather(txt_emb, loss_group))
        return hits[lo:lo + rows]

    return Task("contrastive", model, forward, loss, metric,
                metric_name="retrieval_top1",
                with_model=lambda module: contrastive_task(module, augment,
                                                           loss_group))


def _contrastive_task(model_name: str, seq_len: int,
                      vocab_size: Optional[int], augment: bool = True,
                      device=None, generator: Optional[torch.Generator] = None,
                      loss_group=None) -> Task:
    """A ``clip_resnet50_bert`` or ``clip_tiny`` contrastive task with
    captions of ``seq_len`` tokens; ``vocab_size=None`` keeps the preset's
    own (30522 and 1000)."""
    ctor = {"clip_resnet50_bert": clip_resnet50_bert,
            "clip_tiny": clip_tiny}.get(model_name)
    if ctor is None:
        raise ValueError(f"Invalid model name: {model_name} "
                         "(have ['clip_resnet50_bert', 'clip_tiny'])")
    kwargs = {"max_len": seq_len}
    if vocab_size is not None:
        kwargs["vocab_size"] = vocab_size
    model = ctor(device=device, generator=generator, **kwargs)
    return contrastive_task(model, augment, loss_group)


def get_task(task_type: str, *, num_classes: int = 101,
             model_name: Optional[str] = None, image_size: int = 224,
             seq_len: int = 128, vocab_size: Optional[int] = None,
             augment: bool = True, attention_fn: Optional[Callable] = None,
             remat: bool = False, num_experts: int = 0, moe_every: int = 2,
             pipeline_parallelism: int = 1, pp_microbatches: int = 4,
             device=None, generator: Optional[torch.Generator] = None,
             loss_group=None) -> Task:
    """The task for ``task_type``: ``classification`` (a ResNet or a ViT,
    default ``resnet50``), ``masked_lm`` (default ``bert_base``),
    ``causal_lm`` (default ``gpt_base``) or ``contrastive`` (default
    ``clip_resnet50_bert``). ``image_size`` sizes a ViT's position table;
    the ResNets take any size. ``num_experts``/``moe_every`` give the text
    tasks switch-MoE blocks and ``remat`` rematerializes their blocks (the
    classification and contrastive tasks take neither, as in JAX).
    ``loss_group`` makes the loss the global batch's across its
    processes."""
    if task_type == "classification":
        return _classification_task(num_classes, model_name or "resnet50",
                                    augment, device, generator,
                                    image_size=image_size)
    if task_type == "masked_lm":
        if pipeline_parallelism > 1:
            if attention_fn is not None or num_experts:
                raise ValueError(
                    "pipeline_parallelism composes with dp only "
                    "(not seq/flash/moe) in this release"
                )
            return _pipelined_masked_lm_task(
                vocab_size, model_name or "bert_base", seq_len,
                pipeline_parallelism, pp_microbatches, device, generator,
                loss_group)
        return _masked_lm_task(vocab_size, model_name or "bert_base", seq_len,
                               attention_fn, device, generator, loss_group,
                               num_experts, moe_every, remat)
    if task_type == "causal_lm":
        if pipeline_parallelism > 1:
            raise ValueError(
                "pipeline_parallelism supports masked_lm only in this release"
            )
        return _causal_lm_task(vocab_size, model_name or "gpt_base", seq_len,
                               attention_fn, device, generator, loss_group,
                               num_experts, moe_every, remat)
    if task_type == "contrastive":
        return _contrastive_task(model_name or "clip_resnet50_bert", seq_len,
                                 vocab_size, augment, device, generator,
                                 loss_group)
    raise ValueError(f"Invalid task type: {task_type}")
