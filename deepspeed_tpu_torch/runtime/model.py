"""ModelSpec: what the engine trains.

The port of the JAX package's ``runtime/model.py``: the engine trains a
loss function over a tree (nested dict) of parameter tensors.
``from_gpt`` adapts the port's GPT (next-token loss), ``from_gpt_moe`` its
GPT-MoE (next-token loss plus the weighted load-balancing loss; the
counterpart of ``gpt_moe.model_spec``) and ``from_bert`` its BERT encoder
(masked-LM loss; the counterpart of ``bert.model_spec``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

Params = Any


@dataclasses.dataclass
class ModelSpec:
    #: (params, batch) -> scalar loss tensor; the model casts params to
    #: its compute dtype internally
    loss_fn: Callable[[Params, Any], torch.Tensor]
    #: torch.Generator -> params (fp32 master values) on the generator's
    #: device (``from_gpt``/``from_bert``'s also take ``device=``)
    init_fn: Optional[Callable[[torch.Generator], Params]] = None
    #: pre-materialized params (alternative to init_fn)
    params: Optional[Params] = None
    #: optional forward fn (params, tokens) -> outputs, for eval/inference
    apply_fn: Optional[Callable] = None
    name: str = "model"
    #: free-form extras: the model config; ``layer_stacked`` names the
    #: subtrees whose leaves stack the layers on dim 0 (the engine gives
    #: the loss each layer's slice as its own autograd leaf)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def num_params(self) -> Optional[int]:
        """The parameter count without allocating a parameter: the given
        params', else an init on the meta device (for an ``init_fn`` that
        takes ``device=``, as ``from_gpt``'s and ``from_bert``'s do);
        None when neither tells."""
        if self.params is not None:
            tree = self.params
        else:
            try:
                tree = self.init_fn(torch.Generator(), device="meta")
            except TypeError:
                return None
        return sum(t.numel() for t in _leaves(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def from_gpt(config, dtype=None) -> ModelSpec:
    """Adapt ``deepspeed_tpu_torch.models.gpt`` to a ModelSpec."""
    from ..models import gpt

    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)

    return ModelSpec(
        loss_fn=lambda params, batch: gpt.loss_fn(params, batch, config),
        init_fn=lambda generator, device=None: gpt.init(
            config, generator,
            device=generator.device if device is None else device),
        apply_fn=lambda params, tokens: gpt.apply(params, tokens, config),
        name="gpt",
        meta={"config": config, "layer_stacked": ("blocks",)},
    )


def from_gpt_moe(config, dtype=None) -> ModelSpec:
    """Adapt ``deepspeed_tpu_torch.models.gpt_moe`` to a ModelSpec: its
    three pair stacks are layer-stacked, and ``meta["flops_per_token"]``
    counts the active parameters (``moe_top_k`` routed experts a token,
    no capacity padding)."""
    from ..models import gpt_moe

    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)

    return ModelSpec(
        loss_fn=lambda params, batch: gpt_moe.loss_fn(params, batch, config),
        init_fn=lambda generator, device=None: gpt_moe.init(
            config, generator,
            device=generator.device if device is None else device),
        apply_fn=lambda params, tokens: gpt_moe.apply(
            params, tokens, config, train=False)[0],
        name="gpt-moe",
        meta={"config": config,
              "layer_stacked": ("dense_blocks", "moe_attn_blocks",
                                "moe_blocks"),
              "flops_per_token": gpt_moe.flops_per_token(config)},
    )


def from_bert(config, dtype=None) -> ModelSpec:
    """Adapt ``deepspeed_tpu_torch.models.bert`` to a ModelSpec: the loss
    is the masked-LM cross-entropy of a batch {"tokens", "mlm_labels",
    optional "token_type_ids", "attention_mask", "seq_lens"}."""
    from ..models import bert

    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)

    return ModelSpec(
        loss_fn=lambda params, batch: bert.loss_fn(params, batch, config),
        init_fn=lambda generator, device=None: bert.init(
            config, generator,
            device=generator.device if device is None else device),
        apply_fn=lambda params, tokens: bert.apply(params, tokens, config),
        name="bert",
        meta={"config": config, "layer_stacked": ("blocks",)},
    )
