"""Multi-turn ``InferenceSession`` in the port (CPU, plain kernels) against
the JAX package's on the same weights: a tiny fp32 GPT (2 layers, d 64,
4 heads, vocab 256), numpy weights fed to both sides.  Three turns of
``append`` + ``generate`` give equal greedy tokens and logits within 1e-4
after each ``append``, with a cache in the compute dtype and with an int8
cache; ``fork`` replies as a fresh session does and never reaches its
parent."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.inference import InferenceSession
from deepspeed_tpu_torch.models import convert

from .test_torch_gpt_inference import tiny_params

TOL = 1e-4
#: (prompt, reply) lengths of the three turns
TURNS = ((11, 6), (5, 4), (9, 5))


def serving_configs():
    """(JAX GPTConfig, port GPTConfig) of the serving tests' tiny model:
    the JAX serving tests' ``CFG``."""
    jcfg = jgpt.GPTConfig(vocab_size=256, max_seq_len=128, n_layer=2,
                          n_head=4, d_model=64, dtype=jnp.float32,
                          vocab_round_to=128)
    return jcfg, convert.config_from_jax(jcfg)


def serving_engines(kv_cache_dtype=None, seed=0):
    """(JAX engine, port CPU engine) of the tiny model on the same numpy
    weights, fp32 compute, the KV cache in ``kv_cache_dtype``."""
    jcfg, tcfg = serving_configs()
    tree = tiny_params(jcfg, seed=seed)
    conf = {"dtype": "float32"}
    if kv_cache_dtype is not None:
        conf["kv_cache_dtype"] = kv_cache_dtype
    jeng = deepspeed_tpu.init_inference(
        model=(jcfg, jax.tree_util.tree_map(jnp.asarray, tree)),
        config=dict(conf))
    teng = deepspeed_tpu_torch.init_inference(
        (tcfg, convert.from_jax_params(tree)), dict(conf), device="cpu")
    return jeng, teng


@pytest.fixture(scope="module", params=[None, "int8"], ids=["fp32", "int8"])
def engines(request):
    return request.param, serving_engines(request.param)


def _turns(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (1, s)).astype(np.int32), n)
            for s, n in TURNS]


def test_sessions_match_jax_over_three_turns(engines):
    """Tokens equal and logits within 1e-4 after each append, for three
    turns (the first a prefill, the others extends of the cache that
    holds the earlier replies)."""
    kv, (jeng, teng) = engines
    js = jeng.start_session(batch=1, max_len=64)
    ts = teng.start_session(batch=1, max_len=64)
    assert isinstance(ts, InferenceSession)
    assert ts.cache.max_len == js.cache.max_len and ts.cache.int8 == bool(kv)
    replies = []
    for prompt, n in _turns(1):
        jlg = js.append(jnp.asarray(prompt))
        tlg = ts.append(prompt)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                                   rtol=TOL)
        jr = np.asarray(js.generate(max_new_tokens=n))
        tr = ts.generate(max_new_tokens=n).numpy()
        np.testing.assert_array_equal(tr, jr)
        assert ts.length == js.length
        replies.extend(tr[0].tolist())
    assert len(set(replies)) >= 5
    with pytest.raises(ValueError, match="session cache full"):
        ts.append(np.zeros((1, 64), np.int32))


def test_fork_replies_as_a_fresh_session_and_leaves_the_parent(engines):
    """Forks of one system prompt reply as sessions that prefilled the
    system prompt themselves; a fork's append and generate leave the
    parent's next reply unchanged (the fork copies the cache)."""
    _, (_, teng) = engines
    rng = np.random.default_rng(2)
    system = rng.integers(0, 256, (1, 13)).astype(np.int32)
    turns = [rng.integers(0, 256, (1, n)).astype(np.int32) for n in (4, 7)]
    parent = teng.start_session(batch=1, max_len=64)
    parent.append(system)
    before = [b.clone() for b in parent.cache.buffers()]
    for turn in turns:
        fork = parent.fork()
        assert fork.length == parent.length
        fork.append(turn)
        got = fork.generate(max_new_tokens=6)
        fresh = teng.start_session(batch=1, max_len=64)
        fresh.append(system)
        fresh.append(turn)
        np.testing.assert_array_equal(got.numpy(),
                                      fresh.generate(max_new_tokens=6).numpy())
    assert all(torch.equal(a, b)
               for a, b in zip(before, parent.cache.buffers()))
    alone = teng.start_session(batch=1, max_len=64)
    alone.append(system)
    np.testing.assert_array_equal(parent.generate(max_new_tokens=5).numpy(),
                                  alone.generate(max_new_tokens=5).numpy())


def test_sampled_replies_follow_their_generator(engines):
    """A sampled reply is a function of its generator's seed; without
    one, a session draws from its own seed sequence, so two replies of
    one session differ and two fresh sessions repeat."""
    _, (_, teng) = engines
    prompt = np.random.default_rng(3).integers(0, 256, (1, 9))

    def reply(seed=None, session=None):
        s = session or teng.start_session(batch=1, max_len=64)
        if session is None:
            s.append(prompt)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return s.generate(max_new_tokens=12, do_sample=True, top_p=0.9,
                          generator=gen).numpy()

    np.testing.assert_array_equal(reply(5), reply(5))
    assert (reply(5) != reply(6)).any()
    np.testing.assert_array_equal(reply(), reply())
    s = teng.start_session(batch=1, max_len=64)
    s.append(prompt)
    f = s.fork()
    first = reply(session=s)
    assert (first != reply(session=s)).any()
    # a fork continues its parent's seed sequence from the fork point
    np.testing.assert_array_equal(reply(session=f), first)


def test_session_guards(engines):
    _, (_, teng) = engines
    s = teng.start_session(batch=2, max_len=40)
    assert s.cache.max_len == 64 and s.length == 0   # bucketed, as in JAX
    with pytest.raises(ValueError, match="append"):
        s.generate(max_new_tokens=2)
    with pytest.raises(ValueError, match=r"append wants tokens \[2, S\]"):
        s.append(np.zeros((1, 4), np.int32))
    s.append(np.ones((2, 4), np.int32))
    with pytest.raises(ValueError, match="do_sample"):
        s.generate(max_new_tokens=2, top_k=3)
    assert tuple(s.generate(max_new_tokens=0).shape) == (2, 0)
    with pytest.raises(ValueError, match="session cache full"):
        s.generate(max_new_tokens=61)
