"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its module
names and runs on one NVIDIA H100 through kernels written by hand for
Hopper (``ops/kernels``, sources in ``csrc/``).  It imports ``torch`` and
never JAX or ``deepspeed_tpu``.

Ported so far: the serving path of GPT-2 — ``init_inference`` →
``InferenceEngine.generate``, and the continuous-batching ``SlotBatcher``
(``serving``).
"""

from __future__ import annotations

from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import InferenceEngine
from .models import gpt

__version__ = "0.1.0"


def init_inference(model=None, config=None, device=None, **kwargs
                   ) -> InferenceEngine:
    """Build an :class:`InferenceEngine` (reference
    ``deepspeed/__init__.py`` ``init_inference``).

    ``model`` is a ``(GPTConfig, params)`` tuple of the port's GPT (params
    from ``models.gpt.init`` or ``models.convert.from_jax_params``);
    ``config`` a ``DeepSpeedInferenceConfig`` dict, with remaining kwargs
    merged into it.  ``device=None`` runs on CUDA and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch path."""
    cfg_dict = dict(config or {})
    cfg_dict.update(kwargs)
    inf_config = DeepSpeedInferenceConfig.from_dict(cfg_dict)
    if not (isinstance(model, tuple) and len(model) == 2
            and isinstance(model[0], gpt.GPTConfig)):
        raise TypeError("init_inference takes model=(GPTConfig, params) of "
                        "deepspeed_tpu_torch.models.gpt")
    model_config, params = model
    return InferenceEngine(model_config, params, inf_config, device=device)


__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "init_inference"]
