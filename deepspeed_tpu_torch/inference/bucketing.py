"""Power-of-two bucketing for serving geometry (a copy of the JAX
package's ``inference/bucketing.py``, which is framework-free).

Bucketing reply budgets and cache lengths keeps the set of serving shapes
small: the batcher's slot cache and ``generate``'s cache are sized by
these helpers exactly as the JAX package sizes them, so the two packages
run the same geometry and the tests compare like with like.
"""

from __future__ import annotations

#: no bucket smaller than this
MIN_BUCKET = 8


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"bucketing needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def bucket_max_new_tokens(n: int, cap: int | None = None) -> int:
    """Round a reply budget up to its power-of-two bucket (floor
    :data:`MIN_BUCKET`), clamped to ``cap`` when given."""
    b = max(next_pow2(n), MIN_BUCKET)
    if cap is not None:
        if n > cap:
            raise ValueError(f"max_new_tokens {n} exceeds cap {cap}")
        b = min(b, int(cap))
    return b


def bucket_cache_len(n: int, cap: int) -> int:
    """Round a cache length up to its power-of-two bucket (floor
    :data:`MIN_BUCKET`), clamped to the model context ``cap``."""
    if n < 1:
        raise ValueError(f"cache length must be >= 1, got {n}")
    return min(max(next_pow2(n), MIN_BUCKET), int(cap))


def tile_cache_len(max_len: int, cap: int) -> int:
    """Round a cache length up to a 128 multiple, clamped to the model
    context ``cap`` (the batch ``generate()`` cache geometry)."""
    max_len = -(-max_len // 128) * 128 if max_len > 128 else max_len
    return min(max_len, cap)


def bucket_draft_k(k: int, cap: int) -> int:
    """Round a speculative draft depth so the ``k + 1``-token verify
    window is a power of two (1→1, 2→3, 3→3, 4→7, …), clamped so the
    window never exceeds ``cap`` positions (the slot's overshoot
    budget)."""
    if k < 1:
        raise ValueError(f"draft_k must be >= 1, got {k}")
    b = next_pow2(int(k) + 1) - 1
    return max(1, min(b, int(cap) - 1))
