"""The port's ``SlotBatcher`` (CPU) on a tiny fp32 model: staggered
admissions and releases give greedy tokens equal to the JAX package's
``SlotBatcher`` on the same schedule and to the port's own ``generate``
per request; shared prefixes are copied, never extended in place."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import SlotBatcher as JaxSlotBatcher
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.serving import ServingConfig, SlotBatcher

from .test_torch_gpt_inference import tiny_configs, tiny_params


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = tiny_configs()
    tree = tiny_params(jcfg, seed=2)
    jparams = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v))
               for k, v in tree.items()}
    jeng = deepspeed_tpu.init_inference(model=(jcfg, jparams),
                                        config={"dtype": "float32"})
    teng = deepspeed_tpu_torch.init_inference(
        model=(tcfg, convert.from_jax_params(tree)),
        config={"dtype": "float32"}, device="cpu")
    return jeng, teng


def _run_schedule(bat, admit, prompts, steps):
    """Drive a batcher through ``steps``: ("admit", row, i), ("release",
    row) or ("tick", n).  Returns each request's emitted greedy tokens."""
    owner, got = {}, {i: [] for i in range(len(prompts))}
    for step in steps:
        if step[0] == "admit":
            _, row, i = step
            admit(bat, row, prompts[i])
            owner[row] = i
        elif step[0] == "release":
            bat.release(step[1])
            owner.pop(step[1])
        else:
            for _ in range(step[1]):
                toks = np.asarray(bat.tick())
                for row, i in owner.items():
                    got[i].append(int(toks[row]))
    return got


SCHEDULES = {
    (3, 8): ([5, 11, 7, 19, 3],
             [("admit", 0, 0), ("admit", 1, 1), ("tick", 3), ("admit", 2, 2),
              ("tick", 2), ("release", 0), ("admit", 0, 3), ("tick", 4),
              ("release", 1), ("admit", 1, 4), ("tick", 3)]),
    (2, 16): ([21, 6, 33, 14],
              [("admit", 1, 0), ("tick", 2), ("admit", 0, 1), ("tick", 3),
               ("release", 1), ("admit", 1, 2), ("tick", 2), ("release", 0),
               ("admit", 0, 3), ("tick", 4)]),
}


@pytest.mark.parametrize("slots,chunk", sorted(SCHEDULES))
def test_batcher_matches_jax_batcher_and_generate(engines, slots, chunk):
    jeng, teng = engines
    lens, steps = SCHEDULES[(slots, chunk)]
    rng = np.random.default_rng(slots * 10 + chunk)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]
    conf = {"slots": slots, "max_len": 64, "prefill_chunk": chunk}

    tbat = SlotBatcher(teng, ServingConfig.from_dict(conf))
    got = _run_schedule(tbat, lambda b, row, p: b.admit(row, p, None, True,
                                                        1.0), prompts, steps)
    jbat = JaxSlotBatcher(jeng, JaxServingConfig.from_dict(conf))
    key = jax.random.PRNGKey(0)
    ref = _run_schedule(jbat, lambda b, row, p: b.admit(row, p, key, True,
                                                        1.0), prompts, steps)
    assert got == ref
    for i, p in enumerate(prompts):
        alone = teng.generate(p[None], max_new_tokens=len(got[i])).numpy()
        assert got[i] == alone[0].tolist(), i
    assert sum(len(set(v)) >= 3 for v in got.values()) >= len(prompts) - 1


def test_prefix_is_copied_not_extended(engines):
    _, teng = engines
    bat = SlotBatcher(teng, ServingConfig(slots=2, max_len=64,
                                          prefill_chunk=8))
    rng = np.random.default_rng(5)
    system = rng.integers(0, 512, (12,))
    turns = [np.concatenate([system, rng.integers(0, 512, (n,))])
             for n in (6, 9)]
    entry = bat.build_prefix(system)
    saved = entry.cache.k.clone()
    for row, whole in enumerate(turns):
        bat.admit(row, whole, None, True, 1.0, prefix=entry)
    forked = [bat.tick() for _ in range(5)]
    assert torch.equal(entry.cache.k, saved)
    for row, whole in enumerate(turns):
        bat.release(row)
        bat.admit(row, whole, None, True, 1.0)       # flat, no prefix
    flat = [bat.tick() for _ in range(5)]
    np.testing.assert_array_equal(np.stack(forked), np.stack(flat))
    with pytest.raises(ValueError, match="shorter than"):
        bat.admit(0, system, None, True, 1.0, prefix=entry)


def test_sampled_slot_is_reproducible_and_leaves_greedy_rows(engines):
    _, teng = engines
    conf = ServingConfig(slots=2, max_len=64, prefill_chunk=8, top_p=0.9)
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 512, (10,)), rng.integers(0, 512, (7,))

    def run(seed):
        bat = SlotBatcher(teng, conf)
        bat.admit(0, a, None, True, 1.0)
        bat.admit(1, b, torch.Generator().manual_seed(seed), False, 1.0)
        return np.stack([bat.tick() for _ in range(8)])

    x, y, z = run(3), run(3), run(4)
    np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(x[:, 0], z[:, 0])   # greedy row unmoved
    assert (x[:, 1] != z[:, 1]).any()
    assert x[:, 0].tolist() == teng.generate(a[None], max_new_tokens=8
                                             ).numpy()[0].tolist()


def test_batcher_guards(engines):
    _, teng = engines
    bat = SlotBatcher(teng, ServingConfig(slots=1, max_len=16,
                                          prefill_chunk=8))
    with pytest.raises(RuntimeError, match="before any admission"):
        bat.tick()
    with pytest.raises(ValueError, match="overflows"):
        bat.admit(0, np.zeros(20, np.int64), None, True, 1.0)
    with pytest.raises(ValueError, match="Generator"):
        bat.admit(0, np.zeros(4, np.int64), None, False, 1.0)
    with pytest.raises(DeepSpeedConfigError, match="needs a draft model"):
        SlotBatcher(teng, ServingConfig.from_dict(
            {"slots": 2, "speculative": {"enabled": True}}))
    bat.prewarm()
    assert not bat.active.any()


def test_wide_chunks_give_the_same_tokens(engines):
    """The ``chunk_widen`` rung prefills through double-width chunks; the
    emitted tokens do not change."""
    _, teng = engines
    bat = SlotBatcher(teng, ServingConfig(slots=1, max_len=64,
                                          prefill_chunk=8))
    prompt = np.random.default_rng(8).integers(0, 512, (27,))
    runs = []
    for wide in (False, True):
        bat.set_chunk_wide(wide)
        bat.admit(0, prompt, None, True, 1.0)
        runs.append([int(bat.tick()[0]) for _ in range(6)])
        bat.release(0)
    assert bat.chunk_wide == 16
    assert runs[0] == runs[1]
