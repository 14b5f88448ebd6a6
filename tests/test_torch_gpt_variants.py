"""GPT-Neo's banded local layers and BLOOM's ALiBi and embedding LayerNorm
in the port (CPU, plain kernels) against the JAX package's ``gpt`` and
``gpt_inference`` on tiny fp32 models whose weights are drawn with numpy
and fed to both sides.  Logits to 2e-4 (the dense ALiBi and banded paths
sum in another order than JAX's), the helper functions to 1e-5, the
slopes exactly."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import gpt_inference as jinf
from deepspeed_tpu_torch.models import convert, gpt, gpt_inference as tinf
from deepspeed_tpu_torch.serving import ServingConfig, SlotBatcher

from .test_torch_gpt_inference import tiny_params

TOL = 2e-4
FN_TOL = 1e-5
#: a step that quantizes new K/V into an int8 cache on both sides: the
#: JAX package quantizes under jit (a multiply by the reciprocal scale),
#: the port divides, so a code may differ by one on a rounding tie, which
#: moves a logit by up to about one code step of K or V (absmax / 127)
INT8_STEP_TOL = 2e-3

#: the tiny families: GPT-Neo (alternating global/local layers, window 4,
#: unscaled softmax) and BLOOM (ALiBi, embedding LayerNorm, 6 heads: the
#: interleaved slopes of a non-power-of-two head count)
FAMILIES = {
    "neo": dict(vocab_size=512, max_seq_len=64, n_layer=4, n_head=4,
                d_model=64, attn_softmax_scale=1.0, local_attention_window=4,
                local_attention_alternating=True),
    "bloom": dict(vocab_size=512, max_seq_len=64, n_layer=2, n_head=6,
                  d_model=48, pos_embed="alibi", embed_layernorm=True),
}


def _configs(family):
    jcfg = jgpt.GPTConfig(**FAMILIES[family], dtype=jnp.float32)
    return jcfg, convert.config_from_jax(jcfg)


def _tree(jcfg, seed):
    """``tiny_params`` in the family's layout: no ``wpe`` under ALiBi, the
    embedding LayerNorm's scale and bias when configured."""
    tree = tiny_params(jcfg, seed)
    rng = np.random.default_rng(seed + 100)
    if jcfg.pos_embed != "learned":
        del tree["wpe"]
    if jcfg.embed_layernorm:
        d = jcfg.d_model
        tree["emb_ln_scale"] = (1 + 0.1 * rng.standard_normal(d)).astype(
            np.float32)
        tree["emb_ln_bias"] = (0.1 * rng.standard_normal(d)).astype(
            np.float32)
    return tree


def _jax_tree(tree):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jcfg, tcfg = _configs(request.param)
    tree = _tree(jcfg, seed=3)
    return request.param, jcfg, _jax_tree(tree), tcfg, \
        convert.from_jax_params(tree)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


# ------------------------------------------------------------ the helpers

@pytest.mark.parametrize("H", [2, 6, 12, 16])
def test_alibi_slopes_match_jax(H):
    np.testing.assert_array_equal(gpt.alibi_slopes(H).numpy(),
                                  np.asarray(jgpt.alibi_slopes(H)))


def _qkv(B, Sq, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D))]


@pytest.mark.parametrize("window", [1, 4, 40])
@pytest.mark.parametrize("pos", [None, 20, [3, 29]])
def test_windowed_attention_matches_jax(window, pos):
    """Window 1 (the diagonal), 4 and >= S (plain causal), end-aligned, at
    a shared and at per-row query positions over a longer K/V."""
    jcfg, tcfg = _configs("neo")
    q, k, v = _qkv(2, 5, 35, 4, 16, seed=window)
    jpos = None if pos is None else jnp.asarray(pos, jnp.int32)
    ref = jgpt._windowed_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                   window, pos=jpos)
    tpos = torch.tensor(pos, dtype=torch.int32) \
        if isinstance(pos, list) else pos
    out = gpt._windowed_attention(*map(torch.from_numpy, (q, k, v)), tcfg,
                                  window, pos=tpos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FN_TOL,
                               rtol=FN_TOL)


@pytest.mark.parametrize("pos", [None, 9, [0, 12]])
def test_alibi_attention_matches_jax(pos):
    jcfg, tcfg = _configs("bloom")
    q, k, v = _qkv(2, 4, 16, 6, 8, seed=5)
    if pos is None:
        ref = jgpt._alibi_attention(*map(jnp.asarray, (q, k, v)), jcfg)
        tpos = None
    else:
        first = np.asarray(pos).reshape(-1, 1)
        ref = jgpt._alibi_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                    q_positions=jnp.asarray(
                                        first + np.arange(4)))
        tpos = torch.tensor(pos, dtype=torch.int32) \
            if isinstance(pos, list) else pos
    out = gpt._alibi_attention(*map(torch.from_numpy, (q, k, v)), tcfg,
                               pos=tpos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FN_TOL,
                               rtol=FN_TOL)


def test_embed_layernorm_matches_jax():
    jcfg, tcfg = _configs("bloom")
    tree = _tree(jcfg, seed=4)
    toks = _tokens(2, 9, 1)
    ref = jgpt.embed(_jax_tree(tree), jnp.asarray(toks), jcfg)
    out = gpt.embed(convert.from_jax_params(tree),
                    torch.as_tensor(toks).long(), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FN_TOL,
                               rtol=FN_TOL)


def test_layer_window_follows_jax():
    for family in FAMILIES:
        jcfg, tcfg = _configs(family)
        for idx in range(jcfg.n_layer):
            jw = jgpt.layer_window(jcfg, idx, 1000)
            want = None if jw is None or int(jw) >= 1000 else int(jw)
            assert gpt.layer_window(tcfg, idx) == want


def test_init_tree_follows_the_family():
    for family in FAMILIES:
        jcfg, tcfg = _configs(family)
        params = gpt.init(tcfg)
        assert ("wpe" in params) == (jcfg.pos_embed == "learned")
        assert ("emb_ln_scale" in params) == jcfg.embed_layernorm
        assert ("emb_ln_bias" in params) == jcfg.embed_layernorm


# ----------------------------------------------------------- whole models

def test_apply_matches_jax(family):
    _, jcfg, jp, tcfg, tp = family
    toks = _tokens(2, 20, 0)
    ref = jgpt.apply(jp, jnp.asarray(toks), jcfg)
    out = gpt.apply(tp, torch.as_tensor(toks).long(), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_prefill_then_decode_equals_forward(family):
    """Prefill 10 tokens, decode 6 (prompts and decodes past the window),
    each step's logits equal to the full forward's at that position."""
    _, _, _, tcfg, tp = family
    toks = torch.as_tensor(_tokens(2, 16, 1)).long()
    full = gpt.apply(tp, toks, tcfg)
    cache = tinf.init_cache(tcfg, 2, 32)
    lg, cache = tinf.prefill(tp, toks[:, :10], tcfg, cache)
    np.testing.assert_allclose(lg.numpy(), full[:, :10].numpy(), atol=TOL,
                               rtol=TOL)
    for i in range(10, 16):
        lg, cache = tinf.decode_step(tp, toks[:, i], tcfg, cache)
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(), atol=TOL,
                                   rtol=TOL)


def _copy_cache(tc, jc):
    for name in ("k", "v") + (("k_scale", "v_scale") if tc.int8 else ()):
        getattr(tc, name).copy_(torch.from_numpy(np.array(getattr(jc,
                                                                  name))))


@pytest.mark.parametrize("step", ["decode_ragged", "decode_scalar",
                                  "extend_ragged", "extend_scalar"])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_cached_steps_match_jax(family, kv, step):
    """prefill on both sides, then JAX's cache copied into the port's (an
    int8 code may flip on a rounding tie) and one decode or extend step,
    ragged or not, with a fp32 or an int8 cache (``INT8_STEP_TOL``: the
    step quantizes its new K/V on each side)."""
    _, jcfg, jp, tcfg, tp = family
    toks = _tokens(2, 14, 9)
    jlg, jc = jinf.prefill(jp, jnp.asarray(toks), jcfg,
                           jinf.init_cache(jcfg, 2, 32, kv_dtype=kv))
    tlg, tc = tinf.prefill(tp, torch.as_tensor(toks).long(), tcfg,
                           tinf.init_cache(tcfg, 2, 32, kv_dtype=kv))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _copy_cache(tc, jc)
    lengths = [7, 11]
    ragged = step.endswith("ragged")
    kw = {"lengths": lengths} if ragged else {}
    jkw = {"lengths": jnp.asarray(lengths, jnp.int32)} if ragged else {}
    if step.startswith("decode"):
        nxt = np.asarray([3, 77], np.int32)
        jlg, jc = jinf.decode_step(jp, jnp.asarray(nxt), jcfg, jc, **jkw)
        tlg, tc = tinf.decode_step(tp, torch.as_tensor(nxt).long(), tcfg, tc,
                                   **kw)
    else:
        chunk = _tokens(2, 6, 10)
        jlg, jc = jinf.extend(jp, jnp.asarray(chunk), jcfg, jc, **jkw)
        tlg, tc = tinf.extend(tp, torch.as_tensor(chunk).long(), tcfg, tc,
                              **kw)
    tol = INT8_STEP_TOL if kv else TOL
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=tol,
                               rtol=tol)
    assert tc.length == int(jc.length)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_batcher_equals_generate(family, kv):
    """A SlotBatcher with 8-token prefill chunks (extend past the window)
    and staggered admissions: each greedy request's tokens equal those of
    the prompt alone in the same batcher, and with a fp32 cache those of a
    ``generate`` of it (an int8 cache's chunked prefill reads quantized
    K/V where ``generate``'s prefill reads the fresh ones)."""
    _, _, _, tcfg, tp = family
    conf = {"dtype": "float32"}
    if kv:
        conf["kv_cache_dtype"] = kv
    eng = deepspeed_tpu_torch.init_inference((tcfg, tp), conf, device="cpu")
    prompts = [_tokens(1, n, 20 + n)[0] for n in (13, 5, 19)]
    bat = SlotBatcher(eng, ServingConfig(slots=2, max_len=48,
                                         prefill_chunk=8))
    got = {0: [], 1: [], 2: []}
    bat.admit(0, prompts[0], None, True, 1.0)
    bat.admit(1, prompts[1], None, True, 1.0)
    for _ in range(4):
        toks = bat.tick()
        got[0].append(int(toks[0]))
        got[1].append(int(toks[1]))
    bat.release(1)
    bat.admit(1, prompts[2], None, True, 1.0)
    for _ in range(4):
        toks = bat.tick()
        got[0].append(int(toks[0]))
        got[2].append(int(toks[1]))
    for i, n in ((0, 8), (1, 4), (2, 4)):
        bat.release(0)
        bat.release(1)
        bat.admit(0, prompts[i], None, True, 1.0)
        alone = [int(bat.tick()[0]) for _ in range(n)]
        assert got[i] == alone, (i, got[i], alone)
        if kv is None:
            gen = eng.generate(prompts[i][None], max_new_tokens=n)[0]
            assert gen.tolist() == alone, (i, gen.tolist(), alone)


@pytest.mark.parametrize("field,value", [
    ("pos_embed", "rotary"), ("activation", "relu"),
    ("parallel_residual", True), ("tie_word_embeddings", False),
    ("lm_head_bias", True), ("pos_offset", 2)])
def test_other_variants_still_raise(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        gpt.GPTConfig(**{field: value})


@pytest.mark.parametrize("remat", [False, True],
                         ids=["plain", "remat_attn_out"])
def test_banded_gradients_match_jax(remat):
    """A gradient through GPT-Neo's banded layers (the window option of the
    flash backward, its plain version here): the tiny model's loss and the
    gradient of every parameter against ``jax.value_and_grad`` of the JAX
    ``loss_fn`` on the same weights and tokens (32 positions, window 4),
    plain and under remat ``attn_out``, where the banded layers replay
    their saved O and lse.  Loss to ``FN_TOL``; each gradient to ``TOL``
    times max(1, its largest element): the unscaled softmax over these
    std-0.3 weights turns fp32 summation-order noise into gradient
    differences of up to about 7e-5 of the largest element here (2.7e-4
    with every layer global)."""
    import jax
    jcfg, tcfg = _configs("neo")
    tree = _tree(jcfg, seed=5)
    tokens = _tokens(2, 33, seed=6)
    jloss, jgrads = jax.value_and_grad(jgpt.loss_fn)(
        _jax_tree(tree), {"tokens": jnp.asarray(tokens)}, jcfg)
    if remat:
        tcfg = dataclasses.replace(tcfg, remat=True, remat_policy="attn_out")
    params = convert.from_jax_params(tree)
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    loss = gpt.loss_fn(params, {"tokens": torch.from_numpy(tokens).long()},
                       tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=FN_TOL, atol=FN_TOL)
    got = convert.to_numpy_params(
        jax.tree_util.tree_map(lambda p: p.grad, params))
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(want[path])
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= TOL, (jax.tree_util.keystr(path), err)
