"""The port's GPT-MoE serving path (CPU, plain kernels) against the JAX
package's ``gpt_moe_inference`` and its engine, on one tiny fp32 model
whose JAX parameters (drawn by ``gpt_moe.init`` and scaled so that the
routing spreads and greedy decoding does not repeat one token) feed both
sides through numpy.

``prefill`` (one shot, and past 128 gated tokens through ``extend``
chunks), ``extend`` and ragged ``decode_step``: logits to 1e-5 and the
interleaved cache layers to JAX's ``dense_k``/``moe_k`` banks to 1e-5;
the dropless contract under skewed routing (an extend chunk equals its
tokens decoded one by one, 2e-5); greedy ``generate`` equal to the JAX
engine's; int8 weights and an int8 cache (fp32 compute on the JAX int8
engine's codes: logits 1e-4, cache codes within one step); the batcher
equal to each request alone; a session and a gateway reply equal to
``generate``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import quantization as jquant
from deepspeed_tpu.models import gpt_moe as jmoe
from deepspeed_tpu.models import gpt_moe_inference as jinf
from deepspeed_tpu_torch.inference.quantization import (Int8Param,
                                                        quantize_params_int8)
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt_moe_inference as tinf
from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.serving import ServingConfig, SlotBatcher

from .test_torch_quantizer import assert_jit_close

TOL = 1e-5
INT8_TOL = 1e-4

#: top-2 over 4 experts, residual MoE off (the serving preset's layout)
CFG = jmoe.GPTMoEConfig(
    vocab_size=128, max_seq_len=256, n_layer=4, n_head=2, d_model=32,
    dtype=jnp.float32, vocab_round_to=128, num_experts=4, moe_top_k=2,
    eval_capacity_factor=8.0, min_capacity=16)


def _scaled(params, factor=3.0):
    """Weights scaled up so the gates spread and the logits separate."""
    return jax.tree_util.tree_map(
        lambda a: a * factor if a.ndim >= 2 else a, params)


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, port config), the same numbers."""
    tree = jax.device_get(_scaled(jmoe.init(CFG, jax.random.PRNGKey(0))))
    tcfg = convert.moe_config_from_jax(CFG, dtype=torch.float32)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        convert.from_jax_params(tree), tcfg, tree


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 128, (B, S)).astype(
        np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a)).long()


def _assert_banks(tc, jc, tol=TOL):
    """The port's interleaved layers against JAX's two banks."""
    for name, bank in (("k", "dense_k"), ("v", "dense_v")):
        np.testing.assert_allclose(getattr(tc, name)[0::2].numpy(),
                                   np.asarray(getattr(jc, bank)),
                                   atol=tol, rtol=tol)
    for name, bank in (("k", "moe_k"), ("v", "moe_v")):
        np.testing.assert_allclose(getattr(tc, name)[1::2].numpy(),
                                   np.asarray(getattr(jc, bank)),
                                   atol=tol, rtol=tol)
    assert tc.length == int(jc.length)


@pytest.mark.parametrize("B,S", [(2, 12), (2, 150)],
                         ids=["one_shot", "chunked"])
def test_prefill_matches_jax(model, B, S):
    """B·S ≤ 128 gated tokens in one call; 300 walk through extend chunks
    of 64 tokens on both sides."""
    jp, tp, tcfg, _ = model
    toks = _tokens(B, S, seed=S)
    jlg, jc = jinf.prefill(jp, jnp.asarray(toks), CFG,
                           jinf.init_cache(CFG, B, 160))
    tlg, tc = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, B, 160))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_banks(tc, jc)
    # logits_at keeps each row's vector from the chunk that holds it
    at = torch.tensor([S - 1, S // 3])
    last, _ = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, B, 160),
                           logits_at=at)
    np.testing.assert_allclose(last.numpy(),
                               np.asarray(jlg)[np.arange(B), at.numpy()],
                               atol=TOL, rtol=TOL)


def test_extend_and_ragged_decode_match_jax(model):
    """prefill 8, extend 6, then 3 ragged decode steps at frontiers
    [14, 9] (row 1's right-padded prompt), logits and banks each step."""
    jp, tp, tcfg, _ = model
    toks = _tokens(2, 14, seed=1)
    _, jc = jinf.prefill(jp, jnp.asarray(toks[:, :8]), CFG,
                         jinf.init_cache(CFG, 2, 32))
    _, tc = tinf.prefill(tp, _t(toks[:, :8]), tcfg,
                         tinf.init_cache(tcfg, 2, 32))
    jlg, jc = jinf.extend(jp, jnp.asarray(toks[:, 8:]), CFG, jc)
    tlg, tc = tinf.extend(tp, _t(toks[:, 8:]), tcfg, tc)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_banks(tc, jc)
    lengths = np.array([14, 9], np.int32)
    for step, nxt in enumerate(_tokens(3, 2, seed=2)):
        jlg, jc = jinf.decode_step(jp, jnp.asarray(nxt), CFG, jc,
                                   lengths=jnp.asarray(lengths))
        tlg, tc = tinf.decode_step(tp, _t(nxt), tcfg, tc, lengths=lengths)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                                   rtol=TOL, err_msg=f"step {step}")
        lengths = lengths + 1
    _assert_banks(tc, jc)


def test_dropless_under_skewed_routing():
    """JAX ``test_moe_inference_dropless_under_skewed_routing``: eval
    capacity 0.25 with min capacity 1 would drop in an 8-token chunk,
    but serving is dropless, so the chunk equals its 8 tokens decoded one
    by one (2e-5), on the port as in JAX; and the chunk's logits equal
    JAX's."""
    cfg = jmoe.GPTMoEConfig(
        vocab_size=128, max_seq_len=64, n_layer=2, n_head=2, d_model=32,
        dtype=jnp.float32, vocab_round_to=128, num_experts=8, moe_top_k=2,
        capacity_factor=0.25, eval_capacity_factor=0.25, min_capacity=1)
    tree = jax.device_get(jmoe.init(cfg, jax.random.PRNGKey(0)))
    tp, tcfg = convert.from_jax_params(tree), \
        convert.moe_config_from_jax(cfg, dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 128, size=(1, 6)).astype(np.int32)
    chunk = rng.integers(0, 128, size=(1, 8)).astype(np.int32)

    _, c_ext = tinf.prefill(tp, _t(prompt), tcfg, tinf.init_cache(tcfg, 1, 32))
    ext, c_ext = tinf.extend(tp, _t(chunk), tcfg, c_ext)
    _, c_dec = tinf.prefill(tp, _t(prompt), tcfg, tinf.init_cache(tcfg, 1, 32))
    dec = []
    for i in range(8):
        lg, c_dec = tinf.decode_step(tp, _t(chunk[:, i]), tcfg, c_dec)
        dec.append(lg.numpy())
    np.testing.assert_allclose(ext.numpy()[0], np.stack(dec)[:, 0],
                               rtol=2e-5, atol=2e-5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    _, jc = jinf.prefill(jp, jnp.asarray(prompt), cfg,
                         jinf.init_cache(cfg, 1, 32))
    jext, _ = jinf.extend(jp, jnp.asarray(chunk), cfg, jc)
    np.testing.assert_allclose(ext.numpy(), np.asarray(jext), rtol=TOL,
                               atol=TOL)


def test_extend_overflow_raises(model):
    _, tp, tcfg, _ = model
    _, cache = tinf.prefill(tp, _t(np.zeros((1, 12))), tcfg,
                            tinf.init_cache(tcfg, 1, 16))
    with pytest.raises(ValueError, match="overflows the cache"):
        tinf.extend(tp, _t(np.zeros((1, 8))), tcfg, cache)


def test_routes_gather_and_buffer_paths_agree(model, monkeypatch):
    """Decode's few routes run on gathered experts; forcing the buffer
    path instead gives the same logits."""
    _, tp, tcfg, _ = model
    toks = _tokens(2, 10, seed=4)
    _, cache = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 2, 16))
    snap = [b.clone() for b in cache.buffers()]
    a, _ = tinf.decode_step(tp, _t([5, 9]), tcfg, cache)
    for dst, src in zip(cache.buffers(), snap):
        dst.copy_(src)
    cache.length = 10
    monkeypatch.setattr(sharded_moe, "GATHER_MAX_ROUTES", 0)
    b, _ = tinf.decode_step(tp, _t([5, 9]), tcfg, cache)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def engines(model):
    """The JAX engine and the port's CPU engine, fp32."""
    jp, _, tcfg, tree = model
    jeng = deepspeed_tpu.init_inference(model=(CFG, jp),
                                        config={"dtype": "float32"})
    teng = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)),
        {"dtype": "float32", "moe": {"ep_size": 1}}, device="cpu")
    return jeng, teng


def test_generate_matches_jax_engine(engines):
    """Greedy tokens of 3 ragged prompts equal the JAX engine's."""
    jeng, teng = engines
    toks = _tokens(3, 20, seed=5)
    lens = [20, 13, 6]
    want = np.asarray(jeng.generate(jnp.asarray(toks), max_new_tokens=8,
                                    prompt_lens=jnp.asarray(lens)))
    got = teng.generate(toks, max_new_tokens=8, prompt_lens=lens).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0].tolist())) >= 3


def test_batcher_equals_each_request_alone(engines):
    """3 requests through 2 slots (chunk 8: prompts of 21 and 13 tokens
    extend after their first chunk): each greedy reply equals the same
    request alone and the engine's ``generate``."""
    _, teng = engines
    prompts = [_tokens(1, n, seed=10 + n)[0] for n in (21, 13, 5)]
    bat = SlotBatcher(teng, ServingConfig(slots=2, max_len=64,
                                          prefill_chunk=8))
    bat.admit(0, prompts[0], None, True, 1.0)
    bat.admit(1, prompts[1], None, True, 1.0)
    together = {0: [], 1: []}
    for _ in range(6):
        out = bat.tick()
        together[0].append(int(out[0]))
        together[1].append(int(out[1]))
    bat.release(0)
    bat.admit(0, prompts[2], None, True, 1.0)
    together[2] = [int(bat.tick()[0]) for _ in range(6)]
    for i, prompt in enumerate(prompts):
        alone = SlotBatcher(teng, ServingConfig(slots=2, max_len=64,
                                                prefill_chunk=8))
        alone.admit(1, prompt, None, True, 1.0)
        assert together[i] == [int(alone.tick()[1]) for _ in range(6)]
        ref = teng.generate(prompt[None], max_new_tokens=6)[0].tolist()
        assert together[i] == ref


def test_session_and_gateway_reply(engines, tmp_path):
    """A session's ``append`` + ``generate`` and a gateway request give
    ``generate``'s tokens; a second turn continues the cache."""
    _, teng = engines
    prompt = _tokens(1, 17, seed=20)
    want = teng.generate(prompt, max_new_tokens=7)[0].numpy()
    s = teng.start_session(max_len=64)
    s.append(prompt)
    np.testing.assert_array_equal(s.generate(max_new_tokens=7)[0].numpy(),
                                  want)
    s.append(_tokens(1, 5, seed=21))
    assert s.length == 17 + 7 + 5 and s.generate(max_new_tokens=3).shape \
        == (1, 3)
    gw = teng.serve(config={"slots": 2, "max_len": 64, "prefill_chunk": 8})
    try:
        reply = gw.submit(prompt[0], max_new_tokens=7).result(timeout=60)
    finally:
        gw.shutdown()
    np.testing.assert_array_equal(reply, want)


def test_int8_weights_and_cache_match_jax_int8_engine(model):
    """``dtype="int8"``: the port quantizes the same leaves as JAX's
    ``quantize_params_int8`` (8: the dense and attention stacks and the
    expert ``wi``/``wo``; the gate, ``coefficient`` and ``wte`` stay) to
    the JAX int8 engine's codes; on those codes, prefill + ragged decode
    through an int8 cache in fp32 compute match JAX's (logits 1e-4,
    cache scales 1e-4, codes within one step)."""
    jp, _, tcfg, tree = model
    conf = {"dtype": "int8", "kv_cache_dtype": "int8"}
    jeng = deepspeed_tpu.init_inference(model=(CFG, jp), config=dict(conf))
    teng = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)), dict(conf), device="cpu")
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    _, jn = jquant.quantize_params_int8(jbf)
    _, tn = quantize_params_int8(
        convert.from_jax_params(tree, dtype=torch.bfloat16))
    assert tn == jn == 8
    experts = teng.params["moe_blocks"]["experts"]
    assert isinstance(experts["wi"], Int8Param)
    assert not isinstance(teng.params["moe_blocks"]["gate"]["wg"], Int8Param)
    for path in (("moe_blocks", "experts", "wi"), ("moe_blocks", "experts",
                                                   "wo"),
                 ("moe_attn_blocks", "wqkv"), ("dense_blocks", "wi")):
        mine, theirs = teng.params, jeng.params
        for k in path:
            mine, theirs = mine[k], theirs[k]
        assert_jit_close(mine.q, mine.scale, theirs.q, theirs.scale)

    # fp32 compute on the JAX int8 engine's weights
    jq = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jeng.params)
    tq = convert.from_jax_params(jax.device_get(jq))
    toks = _tokens(2, 12, seed=30)
    jlg, jc = jinf.prefill(jq, jnp.asarray(toks), CFG,
                           jinf.init_cache(CFG, 2, 32, kv_dtype="int8"))
    tlg, tc = tinf.prefill(tq, _t(toks), tcfg,
                           tinf.init_cache(tcfg, 2, 32, kv_dtype="int8"))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=INT8_TOL,
                               rtol=INT8_TOL)
    lengths = np.array([12, 7], np.int32)
    for nxt in _tokens(2, 2, seed=31):
        jlg, jc = jinf.decode_step(jq, jnp.asarray(nxt), CFG, jc,
                                   lengths=jnp.asarray(lengths))
        tlg, tc = tinf.decode_step(tq, _t(nxt), tcfg, tc, lengths=lengths)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=INT8_TOL, rtol=INT8_TOL)
        lengths = lengths + 1
    for name, (dense, moe) in (("k", ("dense_k", "moe_k")),
                               ("v", ("dense_v", "moe_v"))):
        for sl, bank in ((slice(0, None, 2), dense), (slice(1, None, 2), moe)):
            np.testing.assert_allclose(
                getattr(tc, name + "_scale")[sl].numpy(),
                np.asarray(getattr(jc, bank + "_scale")), rtol=INT8_TOL,
                atol=0)
            diff = np.abs(getattr(tc, name)[sl].numpy().astype(np.int32)
                          - np.asarray(getattr(jc, bank)).astype(np.int32))
            assert diff.max() <= 1
    # the port's own int8 engine serves: greedy tokens in range, varied
    out = teng.generate(toks, max_new_tokens=6, prompt_lens=[12, 7])
    assert out.shape == (2, 6) and int(out.max()) < CFG.vocab_size


def test_config_takes_moe_ep_size_one_only():
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    assert DeepSpeedInferenceConfig.from_dict(
        {"moe": {"ep_size": 1, "enabled": True}}).ep_size == 1
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        DeepSpeedInferenceConfig.from_dict({"moe": {"ep_size": 2}})
    with pytest.raises(NotImplementedError, match="not ported"):
        DeepSpeedInferenceConfig.from_dict({"moe": {"moe_experts": [8]}})
