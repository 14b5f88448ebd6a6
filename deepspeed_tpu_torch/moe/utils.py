"""MoE parameter-tree utilities: the port of ``moe/utils.py``.

Paths are tuples of the nested dict's keys.  The gate weight is dense:
only the expert stacks count as MoE parameters, as in the reference's
``is_moe_param``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

Path = Tuple[str, ...]


def is_moe_param_path(path: Path) -> bool:
    """True for expert parameters only (the gate is excluded)."""
    return any(k == "experts" or "expert" in str(k) for k in path)


def _map_with_path(tree: Any, fn: Callable, path: Path = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def split_moe_param_tree(tree: dict) -> Tuple[dict, dict]:
    """Split into (dense_tree, expert_tree), each of the full structure
    with ``None`` where the leaf belongs to the other."""
    dense = _map_with_path(
        tree, lambda p, x: None if is_moe_param_path(p) else x)
    expert = _map_with_path(
        tree, lambda p, x: x if is_moe_param_path(p) else None)
    return dense, expert


def has_moe_layers(tree: dict) -> bool:
    found = []
    _map_with_path(tree, lambda p, x: found.append(is_moe_param_path(p)))
    return any(found)
