"""The port's block-sparse attention (plain path, CPU) against the JAX
package's: ``block_sparse_attention`` run in Pallas interpret mode (block
128, the TPU kernel's tiling) and ``sparse_mha_reference`` (blocks 16, 32,
64, where the JAX wrapper takes its dense path).  Forward and
``torch.autograd`` gradients of the port against ``jax.grad``; fp32,
tolerances 2e-5 (forward) and 3e-5 (gradients), the JAX package's own
(``tests/unit/ops/test_sparse_attention.py``)."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as psa
from deepspeed_tpu_torch.ops.kernels import (block_sparse_attention,
                                             block_sparse_attention_qkv,
                                             mha_reference, sparse_plan)

#: the modules (each package's ``ops`` exports a function of that name)
jbsa = importlib.import_module("deepspeed_tpu.ops.pallas.block_sparse_attention")
pbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.block_sparse_attention")

FWD_TOL = 2e-5
GRAD_TOL = 3e-5


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _inputs(B, S, H, D, seed):
    """q, k, v and the output weight (the gradient's dO), numpy fp32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _jax(fn, q, k, v, w, layout, block, causal):
    """Forward and ``jax.grad`` of sum(fn(...) * w)."""
    def f(q, k, v):
        return fn(q, k, v, layout, block=block, causal=causal)

    args = [jnp.asarray(x) for x in (q, k, v)]
    out, vjp = jax.jit(lambda *a: jax.vjp(f, *a))(*args)
    grads = jax.jit(vjp)(jnp.asarray(w))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(q, k, v, w, layout, block, causal):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = block_sparse_attention(*leaves, layout, block, causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(w))
    return out.detach().numpy(), [g.numpy() for g in grads], lse


def _assert_close(port, ref):
    (out, grads), (rout, rgrads) = port, ref
    np.testing.assert_allclose(out, rout, atol=FWD_TOL, rtol=FWD_TOL)
    for g, r, name in zip(grads, rgrads, ("dq", "dk", "dv")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def _fixed(S, H, block, causal):
    return jsa.FixedSparsityConfig(
        num_heads=H, block=block, num_local_blocks=2, num_global_blocks=1,
        different_layout_per_head=True, num_different_global_patterns=2,
        attention="unidirectional" if causal else "bidirectional"
    ).make_layout(S)


@pytest.mark.parametrize("S,causal,D", [
    *[pytest.param(S, c, 64, id=f"{S}-{c}") for c in (True, False)
      for S in (256, 512)],
    *[pytest.param(256, c, D, id=f"256-{c}-D{D}") for c in (True, False)
      for D in (80, 96)]])
def test_matches_jax_pallas_kernel(pallas_interpret, S, causal, D):
    """Head dim 64, and GPT-2 2.7B's 80 and 760M's 96, which the Pallas
    kernel takes as one block and the CUDA kernels in the tile of 128."""
    q, k, v, w = _inputs(1, S, 2, D, seed=S + causal)
    lay = _fixed(S, 2, 128, causal)
    ref = _jax(jbsa.block_sparse_attention, q, k, v, w, lay, 128, causal)
    out, grads, _ = _port(q, k, v, w, lay, 128, causal)
    _assert_close((out, grads), ref)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_matches_jax_reference_small_blocks(block, causal):
    """BigBird with random blocks (a different layout per head): the JAX
    wrapper's dense path at blocks below its 128-lane gate."""
    S = 8 * block
    q, k, v, w = _inputs(2, S, 3, 32, seed=block + causal)
    lay = jsa.BigBirdSparsityConfig(
        num_heads=3, block=block, different_layout_per_head=True,
        num_random_blocks=1, num_sliding_window_blocks=3,
        attention="unidirectional" if causal else "bidirectional"
    ).make_layout(S)
    ref = _jax(jbsa.sparse_mha_reference, q, k, v, w, lay, block, causal)
    out, grads, _ = _port(q, k, v, w, lay, block, causal)
    _assert_close((out, grads), ref)


@pytest.mark.parametrize("causal", [True, False])
def test_empty_row_gives_zeros_not_nan(causal):
    """Row 1 of the layout has no live block (the JAX test's index-table
    layout): O = 0, lse = -inf, gradients finite and zero for its
    queries; the rest equals the JAX reference."""
    lay = np.zeros((1, 4, 4), np.int64)
    lay[0, 0, 0] = 1
    lay[0, 2, [0, 2]] = 1
    lay[0, 3, [1, 3]] = 1
    q, k, v, w = _inputs(2, 64, 2, 32, seed=5)
    ref = _jax(jbsa.sparse_mha_reference, q, k, v, w, lay, 16, causal)
    out, grads, lse = _port(q, k, v, w, lay, 16, causal)
    _assert_close((out, grads), ref)
    assert not out[:, 16:32].any()
    assert torch.isneginf(lse[:, :, 16:32]).all()
    assert torch.isfinite(lse[:, :, :16]).all()
    assert not grads[0][:, 16:32].any()


def test_dense_layout_equals_mha_reference():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 96, 2, 32, seed=3))
    lay = psa.DenseSparsityConfig(num_heads=2, block=32).make_layout(96)
    out, _ = block_sparse_attention(q, k, v, lay, 32, causal=True)
    torch.testing.assert_close(out, mha_reference(q, k, v, causal=True),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_plan_cache_builds_once():
    """The index tables of one layout are built once over two calls, and
    once per (config, length) through ``config_plan``."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 64, 2, 32, seed=4))
    lay = np.random.default_rng(11).integers(0, 2, (2, 4, 4))
    before = pbsa.plan_builds
    for _ in range(2):
        block_sparse_attention(q, k, v, lay, 16, causal=True)
    assert pbsa.plan_builds == before + 1
    assert sparse_plan(lay.copy(), 16, True, "cpu") is \
        sparse_plan(lay, 16, True, "cpu")
    cfg = psa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2)
    first = pbsa.config_plan(cfg, 64, True, "cpu")
    assert pbsa.config_plan(cfg, 64, True, "cpu") is first
    assert pbsa.plan_builds == before + 2
    assert first.live_pairs == int(first.mask().sum())


def test_sparse_self_attention_matches_jax(pallas_interpret):
    q, k, v, _ = _inputs(1, 256, 2, 64, seed=8)
    kw = dict(num_heads=2, block=128, num_local_blocks=2,
              attention="unidirectional")
    jattn = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**kw))
    pattn = psa.SparseSelfAttention(psa.FixedSparsityConfig(**kw))
    want = np.asarray(jattn(*(jnp.asarray(x) for x in (q, k, v))))
    got = pattn(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    assert pattn.causal and pattn.get_layout(256) is pattn.get_layout(256)
    assert pattn.density(256) == jattn.density(256)
    with pytest.raises(AssertionError, match="heads"):
        pattn(*(torch.zeros(1, 256, 3, 64) for _ in range(3)))


def test_packed_qkv_gradient_and_replay():
    """``block_sparse_attention_qkv`` on [B, S, 3, H, D]: one gradient of
    that shape equal to the three separate gradients; ``saved`` (O, lse)
    replays the forward, without a forward call, with the same
    gradient."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, 32))
                           .astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 64, 2, 32))
                          .astype(np.float32))
    lay = np.tril(rng.integers(0, 2, (2, 4, 4))) | np.eye(4, dtype=np.int64)
    plan = sparse_plan(lay, 16, True, "cpu")
    leaf = qkv.clone().requires_grad_(True)
    o, lse = block_sparse_attention_qkv(leaf, plan)
    (dqkv,) = torch.autograd.grad(o, leaf, do)
    sep = [qkv[:, :, i].clone().requires_grad_(True) for i in range(3)]
    o2, _ = block_sparse_attention(*sep, plan, 16)
    torch.testing.assert_close(o, o2, atol=0, rtol=0)
    want = torch.stack(torch.autograd.grad(o2, sep, do), dim=2)
    torch.testing.assert_close(dqkv, want, atol=GRAD_TOL, rtol=GRAD_TOL)
    replay = qkv.clone().requires_grad_(True)
    o3, _ = block_sparse_attention_qkv(replay, plan,
                                       saved=(o.detach(), lse))
    assert torch.equal(o3, o.detach())
    torch.testing.assert_close(torch.autograd.grad(o3, replay, do)[0], dqkv,
                               atol=0, rtol=0)


def test_wrong_heads_or_length_raise():
    q = torch.zeros(1, 64, 2, 32)
    plan = sparse_plan(np.ones((3, 4, 4)), 16, True, "cpu")
    with pytest.raises(ValueError, match="heads"):
        block_sparse_attention(q, q, q, plan, 16)
    with pytest.raises(ValueError, match="S 64"):
        block_sparse_attention(torch.zeros(1, 48, 3, 32),
                               *(torch.zeros(1, 48, 3, 32) for _ in range(2)),
                               plan, 16)


# ------------------------------------------------------------- tile tables

def _expand_tiles(table, block, causal, S, columns):
    """The [H, S, S] visibility a tile table describes (``columns``: the
    transposed table, indexed by key tile), built from its entries alone;
    each listed tile must hold a visible pair, and nothing may lie past
    S."""
    e = min(block, pbsa.TILE)
    sub = pbsa.TILE // e
    r = np.arange(pbsa.TILE)
    shift = (r[:, None] // e) * sub + r[None, :] // e
    H, nt = table.cnt.shape
    mask = np.zeros((H, nt * pbsa.TILE, nt * pbsa.TILE), bool)
    for h in range(H):
        for t in range(nt):
            n = table.cnt[h, t]
            ids = table.idx[h, t]
            assert (np.diff(ids[:n]) > 0).all() and not ids[n:].any()
            assert not table.bits[h, t, n:].any()
            for other, bits in zip(ids[:n], table.bits[h, t, :n]):
                qt, kt = (other, t) if columns else (t, other)
                tile = ((bits >> shift) & 1).astype(bool)
                if causal and qt == kt:
                    tile &= r[None, :] <= r[:, None]
                assert tile.any(), (h, qt, kt)
                mask[h, qt * pbsa.TILE:(qt + 1) * pbsa.TILE,
                     kt * pbsa.TILE:(kt + 1) * pbsa.TILE] = tile
    assert not mask[:, S:].any() and not mask[:, :, S:].any()
    return mask[:, :S, :S]


def _assert_tiles_match(layout, block, causal):
    layout = np.asarray(layout, bool)
    S = layout.shape[-1] * block
    rows, cols = pbsa.make_tile_tables(layout, causal, block)
    want = pbsa.block_mask(layout, block, causal)
    np.testing.assert_array_equal(_expand_tiles(rows, block, causal, S, False),
                                  want)
    np.testing.assert_array_equal(_expand_tiles(cols, block, causal, S, True),
                                  want)
    for table in (rows, cols):
        assert sorted(table.order.tolist()) == list(range(table.cnt.size))
        assert (np.diff(table.cnt.ravel()[table.order]) <= 0).all()
        ids = table.packed() & 0xFFFF
        np.testing.assert_array_equal(ids, table.idx)
        np.testing.assert_array_equal(table.packed().view(np.uint32) >> 16,
                                      table.bits)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,S", [(16, 256), (16, 80), (32, 256), (32, 96),
                                     (64, 256), (128, 256)])
def test_tile_tables_reproduce_block_mask(block, S, causal):
    """Random half-full layouts with two empty rows (one at a 64-tile
    edge), every block size, S a multiple of 64 or not (80 at block 16, 96
    at block 32): the row and column tile tables expand to exactly
    ``block_mask``; the orders are permutations, heaviest first."""
    n = S // block
    lay = np.random.default_rng(block + S + causal).integers(0, 2, (3, n, n))
    lay[:, 1] = 0
    lay[:, min(n - 1, max(1, 64 // block))] = 0
    _assert_tiles_match(lay, block, causal)


def _sweep_layouts(S=512, H=4, block=32):
    """The five layout kinds of the on-card sparse sweep."""
    var = psa.VariableSparsityConfig(
        num_heads=H, block=block, num_random_blocks=1,
        local_window_blocks=[2, 4], global_block_indices=[3],
        different_layout_per_head=True).make_layout(S)
    var[:, 5] = 0                                    # an empty row
    return {
        "fixed": psa.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional", different_layout_per_head=True,
            num_different_global_patterns=4).make_layout(S),
        "bigbird": psa.BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=2,
            different_layout_per_head=True).make_layout(S),
        "variable_empty_row": var,
        "bslongformer": psa.BSLongformerSparsityConfig(
            num_heads=H, block=block, num_sliding_window_blocks=3,
            global_block_indices=[0, 9]).make_layout(S),
        "dense": psa.DenseSparsityConfig(num_heads=H,
                                         block=block).make_layout(S)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", ["fixed", "bigbird", "variable_empty_row",
                                  "bslongformer", "dense"])
def test_tile_tables_of_sweep_configs(name, causal):
    _assert_tiles_match(_sweep_layouts()[name], 32, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_tile_table_equals_block_table_at_block_64(causal):
    """At block 64 a tile is a block: the tile tables are the block
    tables, every entry wholly live."""
    lay = np.random.default_rng(6).integers(0, 2, (2, 6, 6))
    idx, cnt, idxT, cntT = pbsa.make_index_tables(lay, causal, 64)
    rows, cols = pbsa.make_tile_tables(lay, causal, 64)
    for table, (want_idx, want_cnt) in ((rows, (idx, cnt)),
                                        (cols, (idxT, cntT))):
        np.testing.assert_array_equal(table.idx, want_idx)
        np.testing.assert_array_equal(table.cnt, want_cnt)
        assert (table.bits == (np.arange(table.idx.shape[-1])
                               < table.cnt[..., None])).all()


def test_plan_holds_tile_tables_on_its_device():
    lay = np.random.default_rng(7).integers(0, 2, (2, 5, 5))
    plan = sparse_plan(lay, 16, True, "cpu")
    for table, dev in zip(pbsa.make_tile_tables(lay, True, 16),
                          (plan.tile_rows, plan.tile_cols)):
        for got, want in zip(dev, (table.packed(), table.cnt, table.order)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------- plain path at tile edges

LOW_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,S", [(16, 80), (32, 96), (64, 192),
                                     (128, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_tile_edges(pallas_interpret, dtype, block, S, causal):
    """What the card holds the tensor-core kernels against: the port's
    plain path in bf16 and fp16 (forward and autograd backward) at the
    64-tile edges (S 80 at block 16 and 96 at block 32 end inside a tile;
    a layout row that starts a 64-tile is empty), against the JAX
    package's ``block_sparse_attention`` in fp32 on the same rounded inputs
    (the Pallas kernels in interpret mode at block 128)."""
    n = S // block
    rng = np.random.default_rng(S + block + causal)
    lay = rng.integers(0, 2, (2, n, n))
    lay[:, :, 0] = 1
    empty = 64 // block if block < 128 else 1       # starts a 64-tile
    lay[:, empty] = 0
    raw = _inputs(1, S, 2, 32, seed=S + causal)
    q, k, v, w = (torch.from_numpy(x).to(dtype).float().numpy() for x in raw)
    t = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    o, lse = block_sparse_attention(*t, lay, block, causal)
    (o.float() * torch.from_numpy(w)).sum().backward()
    jo, jgrads = _jax(jbsa.block_sparse_attention, q, k, v, w, lay, block,
                      causal)
    for got, want, name in zip((o, *(x.grad for x in t)), (jo, *jgrads),
                               ("o", "dq", "dk", "dv")):
        assert got.dtype == dtype
        err = (np.abs(got.detach().float().numpy() - want).max()
               / max(1.0, np.abs(want).max()))
        assert err <= LOW_TOL[dtype], (name, err)
    rows = slice(empty * block, (empty + 1) * block)
    assert not o[:, rows].any() and not t[0].grad[:, rows].any()
    assert torch.isneginf(lse[:, :, rows]).all()
