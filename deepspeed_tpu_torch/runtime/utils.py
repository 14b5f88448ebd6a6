"""Gradient norms, clipping and the overflow check.

The port of ``runtime/utils.py:94-130`` of the JAX package (the
reference's ``clip_grad_norm_`` and ``CheckOverflow``): functions over a
tree of tensors that return device scalars, so nothing reaches the host.
The engine applies them to its one flat gradient buffer.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

Tree = Any


def _leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return []


def _map(fn, tree: Tree) -> Tree:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def global_grad_norm(grads: Tree, norm_type: float = 2.0) -> torch.Tensor:
    """Global norm over all leaves, fp32 (ref ``get_grad_norm``): the norm
    of the leaves' norms, one pass over each leaf."""
    leaves = _leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = [torch.linalg.vector_norm(l.float(), norm_type) for l in leaves]
    if len(norms) == 1:
        return norms[0]
    return torch.linalg.vector_norm(torch.stack(norms), norm_type)


def clip_grads_by_global_norm(grads: Tree, max_norm: float,
                              precomputed_norm: Optional[torch.Tensor] = None
                              ) -> Tuple[Tree, torch.Tensor]:
    """Scale grads so the global norm ≤ max_norm (ref ``clip_grad_norm_``);
    returns (clipped grads, the norm before clipping)."""
    norm = precomputed_norm if precomputed_norm is not None \
        else global_grad_norm(grads)
    coef = clip_coefficient(norm, max_norm)
    return _map(lambda g: (g.float() * coef).to(g.dtype), grads), norm


def clip_coefficient(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-6)), the factor that clips to
    ``max_norm``."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def has_overflow(grads: Tree) -> torch.Tensor:
    """True iff any leaf holds an inf or a nan (ref ``CheckOverflow``), as a
    device bool."""
    leaves = _leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    finite = torch.stack([torch.isfinite(l).all() for l in leaves]).all()
    return ~finite
