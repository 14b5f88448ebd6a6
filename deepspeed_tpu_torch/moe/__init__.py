"""Mixture-of-Experts: the port of ``moe/`` on one device (gating,
index dispatch, expert stacks, the ``MoE`` layer and the parameter-tree
utilities).  ``moe/mappings.py`` (token gather/drop across tensor-parallel
ranks) waits for multi-GPU (ROADMAP.md Queue 1 #7)."""

from .experts import experts_apply, experts_apply_routed, experts_init  # noqa: F401
from .layer import MoE  # noqa: F401
from .sharded_moe import (Routing, TopKGate, moe_layer_forward,  # noqa: F401
                          recording_routes, top1gating, top2gating)
from .utils import (has_moe_layers, is_moe_param_path,  # noqa: F401
                    split_moe_param_tree)
