"""The port's speculative decoding (``inference/speculative.py``; CPU,
plain kernels) against the JAX package's ``speculative_generate`` and the
port's own ``generate``, on tiny fp32 models whose numpy weights feed both
sides.

Greedy speculation must give exactly the target's greedy tokens: on a
target trained on the affine rule ``t[i+1] = (3 t[i] + 7) % 256`` (its
greedy chain changes token every step, so an off-by-one emission shows;
trained once per module with the port's ``initialize``) at draft_k
1/3/5, batched rows at their own frontiers, and on GPT-MoE, ALiBi,
windowed and int8-cache targets; the forward counts equal JAX's, and a
self-draft's are exactly ceil(N / (K+1)) + 1.  The acceptance rule fed
JAX's own uniforms and residual draw gives JAX's accepted counts and
tokens, its residual within 1e-6 of its definition; over 40,000 draws at
V 4 its emitted marginal is within 0.012 of the target row.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import speculative as jspec
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import gpt_moe as jmoe
from deepspeed_tpu_torch.inference import speculative as tspec
from deepspeed_tpu_torch.models import convert, gpt_moe
from deepspeed_tpu_torch.runtime.model import from_gpt

from .test_torch_gpt_inference import tiny_params
from .test_torch_gpt_variants import _configs, _jax_tree, _tree
from .test_torch_moe_inference import CFG as MOE_CFG, _scaled

#: tolerance of the accept rule's emitted marginal over DRAWS draws
MARGINAL_TOL = 0.012
DRAWS = 40_000
#: the residual distribution against its definition
RESID_TOL = 1e-6

TARGET = jgpt.GPTConfig(vocab_size=256, max_seq_len=256, n_layer=2,
                        n_head=4, d_model=64, dtype=jnp.float32,
                        vocab_round_to=128)
DRAFT = jgpt.GPTConfig(vocab_size=256, max_seq_len=256, n_layer=1,
                       n_head=2, d_model=32, dtype=jnp.float32,
                       vocab_round_to=128)
#: the rule prompt [3, 16] the trained fixtures continue
RULE_PROMPT = np.asarray([[3, (3 * 3 + 7) % 256]], np.int32)


def rule_rows(n, length):
    """``n`` rows of the affine rule, each from its own start."""
    rows = []
    for s in range(n):
        t = [(s * 17 + 3) % 256]
        for _ in range(length - 1):
            t.append((t[-1] * 3 + 7) % 256)
        rows.append(t)
    return np.asarray(rows, np.int64)


def train_rule(jcfg, steps, seed=0, lr=3e-3):
    """``jcfg``'s model trained on the rule with the port's ``initialize``
    (fp32, Adam, 8 rows of 65 tokens); the master weights as a numpy tree
    in the JAX layout."""
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(convert.config_from_jax(jcfg)), device="cpu",
        generator=torch.Generator().manual_seed(seed),
        config={"train_micro_batch_size_per_gpu": 8,
                "gradient_accumulation_steps": 1,
                "optimizer": {"type": "Adam", "params": {"lr": lr}},
                "zero_optimization": {"stage": 1},
                "steps_per_print": 1 << 30})
    data = rule_rows(8, 65)
    for _ in range(steps):
        engine.train_batch_fused({"tokens": data})
    return convert.to_numpy_params(engine.state["master"])


def both(jcfg, tree):
    """(JAX params, port CPU engine) of one numpy tree."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    eng = deepspeed_tpu_torch.init_inference(
        (convert.config_from_jax(jcfg), convert.from_jax_params(tree)),
        {"dtype": "float32"}, device="cpu")
    return jp, eng


@pytest.fixture(scope="module")
def trained():
    """The rule-trained target (80 steps), draft (120 steps) and a draft
    that half learned it (20 steps: rows accept different counts), and a
    random draft: {name: (JAX cfg, JAX params, port engine)}."""
    out = {}
    for name, cfg, steps in (("target", TARGET, 80), ("draft", DRAFT, 120),
                             ("partial", DRAFT, 20)):
        out[name] = (cfg,) + both(cfg, train_rule(cfg, steps))
    out["random"] = (DRAFT,) + both(DRAFT, tiny_params(DRAFT, seed=1))
    return out


def _pair(entry):
    """A fixture entry as the port's (GPTConfig, params) draft pair."""
    _, _, eng = entry
    return eng.model_config, eng.params


def _spec(entry_t, entry_d, prompt, n, k, **kw):
    """(port tokens, port forwards, JAX tokens, JAX forwards)."""
    jcfg, jp, eng = entry_t
    dcfg, dp, _ = entry_d
    tdcfg, tdp = _pair(entry_d)
    got, fwds = tspec.speculative_generate(
        eng.params, eng.model_config, tdp, tdcfg,
        torch.as_tensor(prompt).long(), n, k, **kw)
    want, jfwds = jspec.speculative_generate(
        jp, jcfg, dp, dcfg, jnp.asarray(prompt), n, draft_k=k, **kw)
    return got.numpy(), fwds, np.asarray(want), int(jfwds)


@pytest.mark.parametrize("draft_k", [1, 3, 5])
def test_greedy_matches_jax_and_generate(trained, draft_k):
    """Trained target, random draft: the tokens of JAX's
    ``speculative_generate`` and of the port's ``generate``, at JAX's
    forward count."""
    got, fwds, want, jfwds = _spec(trained["target"], trained["random"],
                                   RULE_PROMPT, 16, draft_k)
    plain = trained["target"][2].generate(RULE_PROMPT, max_new_tokens=16)
    assert (plain[0, :-1] != plain[0, 1:]).all(), plain
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, want)
    assert fwds == jfwds and 1 <= fwds <= 16 + 1


def test_trained_draft_takes_fewer_forwards(trained):
    """A draft that learned the same rule gets its proposals accepted:
    the same tokens in fewer target forwards than plain decode's 24."""
    got, fwds, want, jfwds = _spec(trained["target"], trained["draft"],
                                   RULE_PROMPT, 24, 4)
    np.testing.assert_array_equal(
        got, trained["target"][2].generate(RULE_PROMPT,
                                           max_new_tokens=24).numpy())
    np.testing.assert_array_equal(got, want)
    assert fwds == jfwds and fwds < 24


@pytest.mark.parametrize("draft_k", [1, 3, 5])
def test_self_draft_forward_count_is_exact(trained, draft_k):
    """Draft = target: every proposal verifies, so each round emits K+1
    tokens: ceil(N / (K+1)) rounds plus the prefill."""
    _, _, eng = trained["target"]
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (1, 8)))
    got, fwds = tspec.speculative_generate(
        eng.params, eng.model_config, eng.params, eng.model_config, prompt,
        16, draft_k)
    np.testing.assert_array_equal(got, eng.generate(prompt, 16))
    assert fwds == -(-16 // (draft_k + 1)) + 1


def test_batched_ragged_rows_equal_their_own_runs(trained):
    """Rows accept different counts, so their frontiers part; each row of
    a batch equals its batch-1 run and the batched ``generate``."""
    _, _, eng = trained["target"]
    dcfg, dparams = _pair(trained["partial"])
    prompt = torch.as_tensor(rule_rows(3, 6))
    trace = []
    got, fwds = tspec.speculative_generate(
        eng.params, eng.model_config, dparams, dcfg, prompt, 20, 3,
        rounds=trace)
    assert any(len(set(a.tolist())) > 1 for a in trace), trace
    np.testing.assert_array_equal(got, eng.generate(prompt, 20))
    for b in range(3):
        alone, _ = tspec.speculative_generate(
            eng.params, eng.model_config, dparams, dcfg, prompt[b:b + 1],
            20, 3)
        np.testing.assert_array_equal(got[b:b + 1], alone)
    assert fwds == len(trace) + 1


def _variant(kind):
    """(JAX cfg, numpy tree, draft JAX cfg) of a GPT-MoE, ALiBi (BLOOM's
    layout) or windowed (GPT-Neo's) tiny target."""
    if kind == "moe":
        tree = jax.device_get(_scaled(jmoe.init(MOE_CFG,
                                                jax.random.PRNGKey(0))))
        return MOE_CFG, tree, dataclasses.replace(DRAFT, vocab_size=128)
    jcfg, _ = _configs({"alibi": "bloom", "window": "neo"}[kind])
    return jcfg, _tree(jcfg, seed=3), dataclasses.replace(
        DRAFT, vocab_size=512, max_seq_len=64)


@pytest.mark.parametrize("kind", ["moe", "alibi", "window"])
def test_variant_targets_match_jax_and_generate(kind):
    """The verify pass rides each family's ragged ``extend`` (dropless for
    GPT-MoE): greedy tokens equal JAX's and ``generate``'s, batched."""
    jcfg, tree, dcfg = _variant(kind)
    if kind == "moe":
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        eng = deepspeed_tpu_torch.init_inference(
            (convert.moe_config_from_jax(jcfg, dtype=torch.float32),
             convert.from_jax_params(tree)), {"dtype": "float32"},
            device="cpu")
    else:
        jp, eng = _jax_tree(tree), both(jcfg, tree)[1]
    dtree = tiny_params(dcfg, seed=5)
    _, deng = both(dcfg, dtree)
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    got, fwds = eng.generate_speculative(prompt, deng, max_new_tokens=12,
                                         draft_k=3)
    want, jfwds = jspec.speculative_generate(
        jp, jcfg, _jax_tree(dtree), dcfg, jnp.asarray(prompt), 12,
        draft_k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got, eng.generate(prompt, 12))
    assert fwds == int(jfwds)


def test_int8_cache_target_matches_jax(trained):
    """``kv_cache_dtype: "int8"``: the target's cache holds int8 codes on
    both sides, and the greedy tokens agree with JAX's at ``kv_dtype``
    int8 and with the port's own int8 ``generate``."""
    jcfg, jp, _ = trained["target"]
    tree = convert.to_numpy_params(trained["target"][2].params)
    eng = deepspeed_tpu_torch.init_inference(
        (convert.config_from_jax(jcfg), convert.from_jax_params(tree)),
        {"dtype": "float32", "kv_cache_dtype": "int8"}, device="cpu")
    dcfg, dp, _ = trained["random"]
    got, fwds = eng.generate_speculative(RULE_PROMPT, _pair(
        trained["random"]), max_new_tokens=16, draft_k=3)
    want, jfwds = jspec.speculative_generate(
        jp, jcfg, dp, dcfg, jnp.asarray(RULE_PROMPT), 16, draft_k=3,
        kv_dtype=jnp.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got, eng.generate(RULE_PROMPT, 16))
    assert fwds == int(jfwds)


def test_sampling_repeats_under_a_seed_and_top_k_1_is_greedy(trained):
    """Speculative sampling: the same seed gives the same tokens, other
    seeds other tokens (all in the vocabulary); ``top_k=1`` sampling is
    greedy and equals ``generate``; ``temperature=0`` is the greedy path."""
    _, _, eng = trained["target"]
    draft = _pair(trained["draft"])

    def run(seed, **kw):
        return eng.generate_speculative(RULE_PROMPT, draft,
                                        max_new_tokens=12, draft_k=3,
                                        seed=seed, **kw)[0].numpy()

    a = run(7, temperature=0.8)
    np.testing.assert_array_equal(a, run(7, temperature=0.8))
    outs = [run(s, temperature=3.0) for s in range(4)]
    assert any(not np.array_equal(outs[0], o) for o in outs[1:]), outs
    assert all(((o >= 0) & (o < 256)).all() for o in outs + [a])
    greedy = eng.generate(RULE_PROMPT, 12).numpy()
    np.testing.assert_array_equal(run(5, temperature=0.8, top_k=1), greedy)
    np.testing.assert_array_equal(run(5), greedy)
    np.testing.assert_array_equal(
        eng.generate_speculative(RULE_PROMPT, draft, 12, 3, temperature=0.8,
                                 seed=11)[0],
        tspec.speculative_generate(
            eng.params, eng.model_config, draft[1], draft[0],
            torch.as_tensor(RULE_PROMPT).long(), 12, 3, temperature=0.8,
            generator=torch.Generator().manual_seed(11))[0])


def _errors(trained):
    _, _, eng = trained["target"]
    dcfg, dparams = _pair(trained["random"])
    moe = _moe_engine()
    p = torch.as_tensor(RULE_PROMPT).long()
    return {
        "batched sampling": (NotImplementedError, "batch 1", lambda: (
            tspec.speculative_generate(eng.params, eng.model_config,
                                       dparams, dcfg, p.repeat(2, 1), 4, 3,
                                       temperature=0.8))),
        "vocabulary": (ValueError, "vocabulary", lambda: (
            tspec.speculative_generate(
                eng.params, eng.model_config, dparams,
                dataclasses.replace(dcfg, vocab_size=128), p, 4, 3))),
        "overshoot": (ValueError, "overshoot", lambda: (
            eng.generate_speculative(np.zeros((1, 240), np.int32),
                                     (dcfg, dparams), 16, draft_k=4))),
        "filters need temperature": (ValueError, "temperature", lambda: (
            eng.generate_speculative(p, (dcfg, dparams), top_p=0.9))),
        "MoE draft engine": (NotImplementedError, "dense", lambda: (
            eng.generate_speculative(p, moe, 4))),
        "MoE draft config": (TypeError, "dense", lambda: (
            eng.generate_speculative(p, (moe.model_config, moe.params), 4))),
    }


def _moe_engine():
    """A GPT-MoE engine of the MoE tests' config (the port's init)."""
    cfg = convert.moe_config_from_jax(MOE_CFG, dtype=torch.float32)
    return deepspeed_tpu_torch.init_inference(
        (cfg, gpt_moe.init(cfg, torch.Generator().manual_seed(0))),
        {"dtype": "float32"}, device="cpu")


@pytest.mark.parametrize("case", ["batched sampling", "vocabulary",
                                  "overshoot", "filters need temperature",
                                  "MoE draft engine", "MoE draft config"])
def test_validation_errors(trained, case):
    """JAX's refusals, with its messages (``speculative.py:141-172``,
    ``engine.py:308-326``)."""
    err, match, fn = _errors(trained)[case]
    with pytest.raises(err, match=match):
        fn()


def _probs(rng, shape):
    p = rng.random(shape).astype(np.float32) ** 3
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("seed", range(6))
def test_accept_rule_matches_jax_under_its_draws(seed):
    """``spec_accept_rule`` fed the uniforms and the Gumbel draw that
    JAX's ``spec_accept`` makes from its key: the same accepted count and
    token, and the residual within 1e-6 of ``norm(max(p_t - p_d, 0))`` at
    the first rejection (``t_probs[K]`` when all are accepted)."""
    K, V = 4, 16
    rng = np.random.default_rng(seed)
    t_probs, d_probs = _probs(rng, (K + 1, V)), _probs(rng, (K, V))
    if seed % 2:
        d_probs[:] = t_probs[:K]            # a draft that is always right
    d_tok = np.asarray([rng.choice(V, p=d_probs[i] / d_probs[i].sum())
                        for i in range(K)], np.int32)
    key = jax.random.PRNGKey(seed)
    ja, jnxt = jspec.spec_accept(key, jnp.asarray(d_tok),
                                 jnp.asarray(d_probs), jnp.asarray(t_probs))
    u_key, r_key = jax.random.split(key)
    u = np.asarray(jax.random.uniform(u_key, (K,)))
    g = np.asarray(jax.random.gumbel(r_key, (V,), jnp.float32))
    a, nxt, probs = tspec.spec_accept_rule(
        *(torch.as_tensor(x)[None] for x in (u, g)),
        torch.as_tensor(d_tok).long()[None], torch.as_tensor(d_probs)[None],
        torch.as_tensor(t_probs)[None])
    assert int(a) == int(ja) and int(nxt) == int(jnxt)
    ai = int(a)
    if ai < K:
        want = np.maximum(t_probs[ai] - d_probs[ai], 0)
        want = want / want.sum() if want.sum() > 1e-20 else t_probs[ai]
    else:
        want = t_probs[K]
    np.testing.assert_allclose(probs[0].numpy(), want, atol=RESID_TOL)


@pytest.mark.parametrize("t_row,d_row", [
    ([0.4, 0.3, 0.2, 0.1], [0.35, 0.35, 0.2, 0.1]),
    ([0.7, 0.1, 0.1, 0.1], [0.1, 0.1, 0.1, 0.7]),
    ([0.97, 0.01, 0.01, 0.01], [0.01, 0.97, 0.01, 0.01])])
def test_accept_rule_emits_the_target_marginal(t_row, d_row):
    """The rule's exactness, checked empirically as the JAX package does
    (``test_speculative.py:161-188``): over draft draws and accept draws
    from a generator, the first emitted token is distributed as the
    target row, for a draft close to, far from and nearly disjoint from
    it."""
    V, n = 4, DRAWS
    gen = torch.Generator().manual_seed(0)
    t = torch.tensor(t_row)
    d = torch.tensor(d_row)
    t_probs = torch.stack([t, torch.full((V,), 0.25)])[None].expand(
        n, 2, V)
    d_tok = torch.multinomial(d, n, replacement=True, generator=gen)[:, None]
    u = torch.rand((n, 1), generator=gen)
    g = -torch.log(-torch.log(torch.rand((n, V), generator=gen).clamp(
        min=1e-20)))
    a, nxt, _ = tspec.spec_accept_rule(u, g, d_tok, d[None, None].expand(
        n, 1, V), t_probs)
    tok = torch.where(a >= 1, d_tok[:, 0], nxt)
    freq = np.bincount(tok.numpy(), minlength=V) / n
    np.testing.assert_allclose(freq, t_row, atol=MARGINAL_TOL)


def test_accept_rule_bonus_row():
    """An all-accepted round draws the bonus token from ``t_probs[K]``
    (through ``spec_accept_batch``, one generator a row)."""
    V, n = 4, 20_000
    gens = [torch.Generator().manual_seed(i) for i in range(n)]
    t_probs = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.1, 0.2, 0.3, 0.4]])
    a, nxt = tspec.spec_accept_batch(
        gens, torch.zeros((n, 1), dtype=torch.long),
        torch.tensor([[[1.0, 0.0, 0.0, 0.0]]]).expand(n, 1, V),
        t_probs[None].expand(n, 2, V))
    assert int(a.min()) == 1
    freq = np.bincount(nxt.numpy(), minlength=V) / n
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=MARGINAL_TOL)
