"""The port's Mixture-of-Experts (``moe/``, ``models/gpt_moe``, training
through ``initialize(model=from_gpt_moe(...))``) against the JAX
package's on the CPU, from the same seeded inputs and parameters
(``convert.from_jax_params``).

Tolerances: gating's dispatch masks (which hold every route's queue
position) and ``exp_counts`` exactly, combine weights and ``l_aux`` 1e-6;
the MoE layer, the model's logits, loss and gradients 1e-5 (fp32); a
training trajectory's losses 1e-5.  ``RSample`` and ``use_rts`` draw from
a ``torch.Generator``, not threefry, so they are held to their
properties: the Gumbel choice follows the gates' softmax, every slot
holds at most one token, and an expert keeps ``min(count, capacity)``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt_moe as jmoe_model
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe import utils as jutils
from deepspeed_tpu_torch.models import convert, gpt_moe
from deepspeed_tpu_torch.moe import MoE, sharded_moe as tsm, utils as tutils
from deepspeed_tpu_torch.runtime.model import from_gpt_moe
from tests.unit.common import base_config, make_mesh, random_tokens

TOL = 1e-5
GATE_TOL = 1e-6

#: the tiny GPT-MoE: 2 pairs, 4 experts, capacity 1.25 (train) drops
TINY = jmoe_model.GPTMoEConfig(
    vocab_size=256, max_seq_len=64, n_layer=4, n_head=4, d_model=64,
    dtype=jnp.float32, vocab_round_to=128, num_experts=4, moe_top_k=1,
    capacity_factor=1.25, eval_capacity_factor=2.0)


def _logits(t, E, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((t, E)) * scale
            ).astype(np.float32)


# ------------------------------------------------------------------ gating

#: (k, capacity factor, min capacity, drop_tokens): overflow or no drop
GATING = {
    "top1_overflow": (1, 0.5, 2, True),
    "top1_fits": (1, 4.0, 4, True),
    "top1_dropless": (1, 0.5, 2, False),
    "top2_overflow": (2, 0.5, 2, True),
    "top2_fits": (2, 4.0, 4, True),
    "top2_dropless": (2, 0.5, 2, False),
}


@pytest.mark.parametrize("case", list(GATING))
def test_gating_matches_jax(case):
    """Masks (every route's expert and queue slot), ``exp_counts``
    exactly; combine weights and ``l_aux`` to 1e-6.  The skewed logits
    (expert 0 favoured) overflow the small capacities."""
    k, cf, min_cap, drop = GATING[case]
    lg = _logits(48, 6, seed=len(case))
    lg[:, 0] += 0.8
    if k == 1:
        want = jsm.top1gating(jnp.asarray(lg), cf, min_cap,
                              drop_tokens=drop, use_rts=False)
        got = tsm.top1gating(torch.from_numpy(lg), cf, min_cap,
                             drop_tokens=drop, use_rts=False)
    else:
        want = jsm.top2gating(jnp.asarray(lg), cf, min_cap, drop_tokens=drop)
        got = tsm.top2gating(torch.from_numpy(lg), cf, min_cap,
                             drop_tokens=drop)
    (jl, jc, jd, je), (tl, tc, td, te) = want, got
    assert tc.shape == jc.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=GATE_TOL,
                               rtol=GATE_TOL)
    np.testing.assert_allclose(float(tl), float(jl), atol=GATE_TOL,
                               rtol=GATE_TOL)
    if drop and cf < 1:
        assert int(td.sum()) < k * lg.shape[0]      # the case does overflow


def test_top1_used_token_and_first_index_ties():
    """``used_token`` removes tokens from the masks and the counts; an
    exact tie goes to the first expert, as ``jnp.argmax`` breaks it."""
    lg = _logits(16, 4, seed=3)
    lg[5] = lg[5, 2]                      # token 5: all experts tied
    used = (np.arange(16) % 3 != 0).astype(np.float32)
    want = jsm.top1gating(jnp.asarray(lg), 1.0, 2,
                          used_token=jnp.asarray(used), use_rts=False)
    got = tsm.top1gating(torch.from_numpy(lg), 1.0, 2,
                         used_token=torch.from_numpy(used), use_rts=False)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=GATE_TOL)
    r = tsm.top1_routing(torch.from_numpy(lg), 1.0, 2, use_rts=False)
    assert int(r.expert[5, 0]) == 0


def test_rsample_follows_the_gates():
    """``noisy_gate_policy="RSample"``: the Gumbel-perturbed top-1 picks
    expert e with the probability softmax(logits)_e (within 0.02 over
    20,000 draws), repeatably under one generator seed."""
    row = np.array([[1.0, 0.2, -0.5, 0.7]], np.float32)
    lg = torch.from_numpy(np.repeat(row, 20000, axis=0))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tsm.top1_routing(lg, 1.0, 4, noisy_gate_policy="RSample",
                                generator=gen, drop_tokens=False,
                                use_rts=False).expert[:, 0]

    picks = draw(7)
    freq = torch.bincount(picks, minlength=4).float() / picks.numel()
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(lg[0], -1).numpy(), atol=0.02)
    assert torch.equal(picks, draw(7))
    assert not torch.equal(picks, draw(8))


def test_rts_keeps_a_random_subset_within_capacity():
    """``use_rts``: queue places in a random priority order.  Each
    expert keeps min(count, capacity) tokens, each slot at most one; the
    kept tokens of an overfull expert are not always its first ones."""
    lg = _logits(64, 4, seed=5)
    lg[:, 1] += 2.0                       # expert 1 overfull
    firsts = []
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        l_aux, combine, dispatch, counts = tsm.top1gating(
            torch.from_numpy(lg), 1.0, 4, generator=gen, use_rts=True)
        cap = dispatch.shape[-1]
        assert int(dispatch.sum(dim=0).max()) <= 1         # a slot, a token
        assert int(dispatch.sum(dim=(1, 2)).max()) <= 1    # a token, a slot
        kept = dispatch.sum(dim=(0, 2))
        assert torch.equal(kept, torch.clamp(counts, max=cap))
        firsts.append(tuple(torch.nonzero(dispatch[:, 1].any(-1))[:, 0]
                            .tolist()))
    order = tuple(torch.nonzero(torch.from_numpy(lg).argmax(-1) == 1)[:, 0]
                  .tolist()[:cap])
    assert len(set(firsts)) > 1 and any(f != order for f in firsts)


def test_index_dispatch_equals_the_dense_einsums():
    """The port's dispatch by index computes the JAX package's
    ``einsum(dispatch) → experts → einsum(combine)``: capacity-gated, and
    dropless through the buffer and through the gathered experts."""
    rng = np.random.default_rng(4)
    E, d, t = 4, 16, 12
    params = {"wi": torch.from_numpy(rng.standard_normal((E, d, 32)) * 0.3),
              "bi": torch.from_numpy(rng.standard_normal((E, 32)) * 0.1),
              "wo": torch.from_numpy(rng.standard_normal((E, 32, d)) * 0.3),
              "bo": torch.from_numpy(rng.standard_normal((E, d)) * 0.1)}
    params = {k: v.float() for k, v in params.items()}
    x = torch.from_numpy(rng.standard_normal((t, d))).float()
    lg = torch.from_numpy(_logits(t, E, seed=6))
    for k, drop in ((1, True), (2, True), (1, False), (2, False)):
        r = tsm.top1_routing(lg, 0.6, 1, drop_tokens=drop, use_rts=False) \
            if k == 1 else tsm.top2_routing(lg, 0.6, 1, drop_tokens=drop)
        w, _ = tsm.gate_weights(r)
        combine, dispatch = tsm._dense(r, w)
        xe = torch.einsum("tec,td->ecd", dispatch.float(), x)
        ye = tsm.experts_apply(params, xe)
        want = torch.einsum("tec,ecd->td", combine, ye)
        got = tsm._combine_routes(x, r, w, params)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        if not drop:
            assert t * k > tsm.GATHER_MAX_ROUTES or k == 1
            few = dataclasses.replace(
                r, expert=r.expert[:3], slot=r.slot[:3], keep=r.keep[:3])
            torch.testing.assert_close(
                tsm._combine_routes(x[:3], few, w[:3], params), want[:3],
                atol=TOL, rtol=TOL)


# ------------------------------------------------------------------- layer

@pytest.mark.parametrize("use_residual", [False, True],
                         ids=["moe", "residual_moe"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_moe_layer_matches_jax(use_residual, train):
    """``MoE.apply`` (top-2, capacity 1.0 train / 2.0 eval: the train
    case drops) equals the JAX layer's output, ``l_aux`` and counts."""
    kw = dict(hidden_size=32, num_experts=4, k=2, capacity_factor=1.0,
              eval_capacity_factor=2.0, min_capacity=2,
              use_residual=use_residual, use_rts=False)
    jm = jlayer.MoE(**kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 10.0, params)
    x = np.random.default_rng(2).standard_normal((2, 10, 32)).astype(
        np.float32)
    jo, jl, jc = jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(x), train=train)
    to, tl, tc = MoE(**kw).apply(convert.from_jax_params(params),
                                 torch.from_numpy(x), train=train)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(tl), float(jl), atol=GATE_TOL,
                               rtol=GATE_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_param_tree_utilities_match_jax():
    params = jax.device_get(jmoe_model.init(TINY, jax.random.PRNGKey(0)))
    tree = convert.from_jax_params(params)
    assert tutils.has_moe_layers(tree) and jutils.has_moe_layers(params)
    assert not tutils.has_moe_layers({"wte": tree["wte"]})
    dense, expert = tutils.split_moe_param_tree(tree)
    jd, je = jutils.split_moe_param_tree(params)
    assert dense["wte"] is not None and expert["wte"] is None
    assert dense["moe_blocks"]["experts"]["wi"] is None
    assert expert["moe_blocks"]["experts"]["wi"] is not None
    assert dense["moe_blocks"]["gate"]["wg"] is not None
    for mine, theirs in ((dense, jd), (expert, je)):
        assert sorted(p for p, _ in _paths(mine)) == \
            sorted(p for p, v in _paths(theirs) if v is not None)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        elif v is not None:
            yield prefix + (k,), v


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def jax_model():
    """TINY's params (scaled so the routing spreads), a batch, and the JAX
    ``loss_fn``'s loss, gradients and ``apply`` (train and eval)."""
    params = jmoe_model.init(TINY, jax.random.PRNGKey(3))
    params = dict(params)
    params["moe_blocks"] = jax.tree_util.tree_map(
        lambda a: a * 20.0, params["moe_blocks"])
    batch = random_tokens(4, 16, seed=9)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    loss, grads = jax.value_and_grad(
        lambda p: jmoe_model.loss_fn(p, jb, TINY))(params)
    outs = {train: jax.device_get(jmoe_model.apply(
        params, jb["tokens"][:, :-1], TINY, train=train))
        for train in (True, False)}
    return (jax.device_get(params), batch, float(loss),
            jax.device_get(grads), outs)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_gpt_moe_apply_matches_jax(jax_model, train):
    params, batch, _, _, outs = jax_model
    cfg = convert.moe_config_from_jax(TINY, dtype=torch.float32)
    logits, aux = gpt_moe.apply(
        convert.from_jax_params(params),
        torch.from_numpy(batch["tokens"][:, :-1]).long(), cfg, train=train)
    jlogits, jaux = outs[train]
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("overrides", [
    {}, {"remat": True, "remat_policy": "nothing"},
    {"remat": True, "remat_policy": "attn_out"}],
    ids=["plain", "remat_nothing", "remat_attn_out"])
def test_gpt_moe_loss_and_grads_match_jax(jax_model, overrides):
    """LM loss + 0.01 · aux and its gradient in every leaf (the gate's
    through the combine weights and ``l_aux``) against ``jax.grad``; the
    remat replays route on the forward's routing."""
    params, batch, jloss, jgrads, _ = jax_model
    cfg = dataclasses.replace(
        convert.moe_config_from_jax(TINY, dtype=torch.float32), **overrides)
    tree = convert.from_jax_params(params)
    leaves = jax.tree_util.tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    with tsm.recording_routes() as routes:
        loss = gpt_moe.loss_fn(tree, {"tokens": torch.from_numpy(
            batch["tokens"]).long()}, cfg)
        loss.backward()
    assert len(routes) == cfg.n_pairs       # a remat replay routes nothing anew
    np.testing.assert_allclose(float(loss.detach()), jloss, atol=TOL,
                               rtol=TOL)
    got = convert.to_numpy_params(jax.tree_util.tree_map(lambda p: p.grad,
                                                         tree))
    flat = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(g, flat[path], atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(flat) == len(leaves)


def test_flops_per_token_counts_active_experts():
    """One routed expert (k 1) of 64 adds the FLOPs of one dense FFN, not
    64; top-2 adds a second."""
    base = gpt_moe.GPT_MOE_350M_64E
    d = base.d_model
    one = gpt_moe.flops_per_token(base)
    two = gpt_moe.flops_per_token(dataclasses.replace(base, moe_top_k=2))
    assert two - one == 6.0 * base.n_pairs * (8 * d * d + 5 * d)
    assert from_gpt_moe(base).meta["flops_per_token"] == one


def test_config_refuses_other_layouts_and_expert_parallelism():
    with pytest.raises(ValueError, match="even layer count"):
        gpt_moe.GPTMoEConfig(n_layer=3)
    with pytest.raises(ValueError, match="GPT-2's layout"):
        gpt_moe.GPTMoEConfig(n_layer=2, pos_embed="rotary")
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        gpt_moe.GPTMoEConfig(n_layer=2, ep_size=2)
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        MoE(hidden_size=8, num_experts=4, ep_size=2)


# ---------------------------------------------------------------- training

def test_training_matches_jax_engine():
    """3 steps of ``initialize(model=from_gpt_moe(cfg))`` (ZeRO 0, Adam lr
    1e-3, the capacity-gated train path) from the JAX engine's initial
    params: the losses of the JAX engine (ep 1, dp 8, micro 1: a global
    batch of 8) to 1e-5."""
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmoe_model.model_spec(TINY),
        config=base_config(micro_batch=1, stage=0),
        mesh_manager=make_mesh(dp=-1, ep=1), rng=jax.random.PRNGKey(0))
    init = jax.device_get(jeng.state["master"])
    batches = [random_tokens(8, 16, seed=i) for i in range(3)]
    jlosses = []
    for b in batches:
        loss = jeng.forward(b)
        jeng.backward(loss)
        jeng.step()
        jlosses.append(float(loss))
    cfg = convert.moe_config_from_jax(TINY, dtype=torch.float32)
    spec = dataclasses.replace(from_gpt_moe(cfg),
                               params=convert.from_jax_params(init))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config=base_config(micro_batch=8, stage=0,
                                       extra={"moe": {"ep_size": 1}}),
        device="cpu")
    losses = []
    for b in batches:
        loss = peng.forward(b)
        peng.backward(loss)
        peng.step()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=TOL)
    assert losses[-1] < losses[0]
