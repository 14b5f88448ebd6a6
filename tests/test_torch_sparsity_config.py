"""The port's sparsity configurations against the JAX package's: every
class's ``make_layout`` array-equal over a grid of lengths, heads,
per-head layouts and attention kinds (BigBird's and Variable's random
blocks included), the same constructor ``ValueError``s, and equal index
tables and ``density``."""

import importlib

import numpy as np
import pytest

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as psa

#: the modules (each package's ``ops`` exports a function of that name)
jbsa = importlib.import_module("deepspeed_tpu.ops.pallas.block_sparse_attention")
pbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.block_sparse_attention")

ATTN = ("unidirectional", "bidirectional")

#: (class name, constructor kwargs) over the config surface
CONFIGS = [
    ("SparsityConfig", {}),
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", {"num_local_blocks": 4, "num_global_blocks": 1}),
    ("FixedSparsityConfig", {"num_local_blocks": 4, "num_global_blocks": 2,
                             "horizontal_global_attention": True}),
    ("FixedSparsityConfig", {"num_local_blocks": 4, "num_global_blocks": 1,
                             "different_layout_per_head": True,
                             "num_different_global_patterns": 4}),
    ("VariableSparsityConfig", {"num_random_blocks": 2,
                                "local_window_blocks": [2, 3],
                                "global_block_indices": [1, 5]}),
    ("VariableSparsityConfig", {"num_random_blocks": 1,
                                "global_block_indices": [0, 4],
                                "global_block_end_indices": [2, 6],
                                "different_layout_per_head": True,
                                "horizontal_global_attention": True}),
    ("BigBirdSparsityConfig", {"num_random_blocks": 2,
                               "num_sliding_window_blocks": 3,
                               "num_global_blocks": 1}),
    ("BigBirdSparsityConfig", {"num_random_blocks": 1,
                               "different_layout_per_head": True,
                               "num_global_blocks": 2}),
    ("BSLongformerSparsityConfig", {"num_sliding_window_blocks": 5,
                                    "global_block_indices": [0, 7]}),
    ("BSLongformerSparsityConfig", {"global_block_indices": [2],
                                    "global_block_end_indices": [4],
                                    "different_layout_per_head": True}),
    ("LocalSlidingWindowSparsityConfig", {"num_sliding_window_blocks": 3}),
]


def _pair(name, heads, attention, **kw):
    """The same configuration from both packages (``attention`` where the
    class takes it)."""
    if name not in ("SparsityConfig", "DenseSparsityConfig"):
        kw = {**kw, "attention": attention}
    return (getattr(jsa, name)(num_heads=heads, block=16, **kw),
            getattr(psa, name)(num_heads=heads, block=16, **kw))


@pytest.mark.parametrize("attention", ATTN)
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("case", range(len(CONFIGS)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONFIGS)])
def test_make_layout_array_equal(case, heads, attention):
    name, kw = CONFIGS[case]
    if kw.get("horizontal_global_attention") and attention != "bidirectional":
        for pkg in (jsa, psa):        # refused by both constructors
            with pytest.raises(ValueError):
                getattr(pkg, name)(num_heads=heads, block=16,
                                   attention=attention, **kw)
        return
    jcfg, pcfg = _pair(name, heads, attention, **kw)
    for S in (16 * 8, 16 * 10, 16 * 16):
        want = jcfg.make_layout(S)
        got = pcfg.make_layout(S)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


#: constructor arguments each package must refuse with a ValueError
BAD = [
    ("FixedSparsityConfig", {"num_local_blocks": 4, "num_global_blocks": 3}),
    ("FixedSparsityConfig", {"attention": "sideways"}),
    ("FixedSparsityConfig", {"attention": "unidirectional",
                             "horizontal_global_attention": True}),
    ("FixedSparsityConfig", {"num_different_global_patterns": 2}),
    ("FixedSparsityConfig", {"different_layout_per_head": True,
                             "num_local_blocks": 4, "num_global_blocks": 2,
                             "num_different_global_patterns": 3}),
    ("VariableSparsityConfig", {"attention": "unidirectional",
                                "horizontal_global_attention": True}),
    ("VariableSparsityConfig", {"global_block_indices": [0, 2],
                                "global_block_end_indices": [1]}),
    ("LocalSlidingWindowSparsityConfig", {"attention": "both"}),
]


@pytest.mark.parametrize("name,kw", BAD, ids=[f"{n}-{i}" for i, (n, _)
                                              in enumerate(BAD)])
def test_constructor_errors_match(name, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jsa, name)(num_heads=2, block=16, **kw)
    with pytest.raises(ValueError) as perr:
        getattr(psa, name)(num_heads=2, block=16, **kw)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("name,S", [("FixedSparsityConfig", 100),
                                    ("LocalSlidingWindowSparsityConfig", 32)])
def test_make_layout_errors_match(name, S):
    """A length the block does not divide, and a band wider than the row."""
    kw = {"num_sliding_window_blocks": 5} if "Sliding" in name else {}
    msgs = []
    for pkg in (jsa, psa):
        with pytest.raises(ValueError) as err:
            getattr(pkg, name)(num_heads=1, block=16, **kw).make_layout(S)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [2, 4, 5, 7, 9])
def test_index_tables_and_density_equal(case, causal):
    name, kw = CONFIGS[case]
    jcfg, pcfg = _pair(name, 4, "bidirectional", **kw)
    lay = jcfg.make_layout(16 * 12)
    for got, want in zip(pbsa.make_index_tables(lay, causal, 16),
                         jbsa.make_index_tables(lay, causal, 16)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for c in (None, causal):
        assert psa.SparseSelfAttention(pcfg).density(16 * 12, c) == \
            jsa.SparseSelfAttention(jcfg).density(16 * 12, c)


def test_index_tables_with_empty_row():
    """The JAX test's hand-made layout (row 1 empty) in both packages."""
    lay = np.zeros((1, 4, 4), np.int64)
    lay[0, 0, 0] = 1
    lay[0, 2, [0, 2]] = 1
    lay[0, 3, [1, 3]] = 1
    for causal in (True, False):
        for got, want in zip(pbsa.make_index_tables(lay, causal, 128),
                             jbsa.make_index_tables(lay, causal, 128)):
            np.testing.assert_array_equal(got, want)
    assert pbsa.make_index_tables(lay, True, 128)[1].tolist() == [[1, 0, 2, 2]]
