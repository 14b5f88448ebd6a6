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


#: the width of the rows a vector is reduced in, one level at a time
NORM_ROW = 4096


def _vector_norm(x: torch.Tensor, norm_type: float) -> torch.Tensor:
    """The ``norm_type`` norm of ``x`` as a norm of row norms: each level
    takes ``torch.linalg.vector_norm`` over rows of ``NORM_ROW`` elements
    (the tail a row of its own) in one pass, with no full-size temporary,
    until one row is left.  No fp32 sum runs over more than ``NORM_ROW``
    terms, which keeps the host's lane-by-lane accumulation as exact as a
    tree (4.6e-5 relative off on 1M elements in one sum, 1e-8 here)."""
    x = x.reshape(-1).float()
    while x.numel() > NORM_ROW:
        n = x.numel() - x.numel() % NORM_ROW
        rows = torch.linalg.vector_norm(x[:n].view(-1, NORM_ROW), norm_type,
                                        dim=1)
        if n < x.numel():
            rows = torch.cat([rows, torch.linalg.vector_norm(
                x[n:], norm_type).reshape(1)])
        x = rows
    return torch.linalg.vector_norm(x, norm_type)


def global_grad_norm(grads: Tree, norm_type: float = 2.0) -> torch.Tensor:
    """Global norm over all leaves, fp32 (ref ``get_grad_norm``): the norm
    of the leaves' norms, each a norm of row norms (``_vector_norm``), so
    it equals the JAX package's root of summed powers (largest |g| for
    ``inf``) to within fp32 rounding."""
    leaves = _leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = [_vector_norm(l, norm_type) for l in leaves]
    if len(norms) == 1:
        return norms[0]
    return _vector_norm(torch.stack(norms), norm_type)


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
