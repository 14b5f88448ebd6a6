"""Speculative serving in the port (CPU, plain kernels): the
``serving.speculative`` section against the JAX package's
(``tests/unit/serving/test_serving_config.py:41-78``), and the gateway's
draft/verify tick on the tiny fp32 GPT of the session tests.

Greedy replies equal the port's sequential sessions bit for bit, with a
self-draft (every proposal accepted, windows cut at the budget), a draft
that agrees only at times, and a random geometry-spec draft; the ladder's
levels 1 (shrunk rounds) and 2 (paused) keep the greedy chain; admission
keeps the round's overshoot inside the slot; ``serve.spec_round``
carries JAX's fields and ``snapshot()`` JAX's ``spec_*`` keys; a sampled
reply repeats under its seed, alone or beside other requests.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.config import \
    DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.runtime.supervision.events import SUMMARY_FIELDS
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import ServingMetrics as JaxServingMetrics
from deepspeed_tpu_torch.inference.bucketing import bucket_draft_k
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.supervision.events import (EventJournal,
                                                            EventKind)
from deepspeed_tpu_torch.serving import (ServingConfig, SlotBatcher,
                                         SpeculativeConfig)

from .test_torch_gateway import WAIT_S, _session_reply
from .test_torch_sessions import serving_engines
from .test_torch_speculative import DRAFT, train_rule, both

SPEC_DRAFT = {"n_layer": 1, "d_model": 32, "n_head": 2, "seed": 7}


@pytest.fixture(scope="module")
def engine():
    """The tiny fp32 serving engine (vocab 256, context 128)."""
    return serving_engines()[1]


@pytest.fixture(scope="module")
def partial_draft():
    """A draft engine trained 20 steps on the affine rule: it agrees with
    the target only at times."""
    return both(DRAFT, train_rule(DRAFT, 20))[1]


@pytest.fixture
def serve(engine, tmp_path):
    """``serve(draft=None, **config)`` → (gateway, journal), speculation on
    (draft_k 3 unless given); every gateway is shut down after the
    test."""
    made = []

    def make(draft=None, spec=None, **cfg):
        base = {"slots": 3, "max_len": 64, "prefill_chunk": 8,
                "queue_capacity": 16, "idle_wait_s": 0.01,
                "speculative": {"enabled": True, "draft_k": 3,
                                **(spec or {})}}
        base.update(cfg)
        journal = EventJournal(str(tmp_path / f"events{len(made)}.jsonl"))
        gw = engine.serve(config=base, journal=journal, draft=draft)
        made.append(gw)
        return gw, journal

    yield make
    for gw in made:
        gw.shutdown(drain=False, timeout=WAIT_S)


def _requests(rng, n, lo=3, hi=24):
    return [(rng.integers(0, 256, (int(rng.integers(lo, hi)),)).astype(
        np.int32), int(rng.integers(4, 20))) for _ in range(n)]


# ------------------------------------------------- serving.speculative

def test_speculative_defaults_match_jax():
    cfg, jcfg = ServingConfig(), JaxServingConfig()
    assert cfg.speculative is None
    for key in ("enabled", "draft_k", "draft"):
        assert getattr(cfg.speculative_config, key) == \
            getattr(jcfg.speculative_config, key)
    assert cfg.speculative_config == SpeculativeConfig()
    assert [bucket_draft_k(k, 64) for k in (1, 2, 3, 4, 7, 8)] == \
        [1, 3, 3, 7, 7, 15]
    assert bucket_draft_k(4, cap=4) == 3


def test_speculative_round_trip():
    section = {"enabled": True, "draft_k": 4, "draft": dict(SPEC_DRAFT)}
    cfg = ServingConfig.from_dict({"slots": 2, "speculative": section})
    sp = cfg.speculative_config
    assert sp.enabled is True and sp.draft_k == 4 and sp.draft == SPEC_DRAFT
    assert cfg.speculative["draft_k"] == 4
    again = ServingConfig.from_dict(cfg.to_dict())
    assert again == cfg and again.speculative_config == sp
    typed = ServingConfig(speculative=SpeculativeConfig(**section))
    assert typed.speculative == section and typed.speculative_config == sp


@pytest.mark.parametrize("bad", [
    {"draft_k": 0}, {"draft_k": -3}, {"draft_k": 65}, {"draft_k": True},
    {"draft_k": "three"}, {"draft": ["n_layer", 2]},
    {"draft": {"n_layers": 2}}, {"draft": {"n_layer": 0}},
    {"draft": {"d_model": -1}}, {"draft": {"n_head": 0}}])
def test_speculative_invalid_raises_as_in_jax(bad):
    with pytest.raises(JaxConfigError) as jerr:
        JaxServingConfig.from_dict({"speculative": bad})
    with pytest.raises(DeepSpeedConfigError) as err:
        ServingConfig.from_dict({"speculative": bad})
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["no draft", "MoE draft", "vocabulary",
                                  "short context"])
def test_draft_refusals(engine, case):
    """JAX's checks on the draft (``batcher.py:142-200``)."""
    import dataclasses
    conf = ServingConfig(slots=2, max_len=64, prefill_chunk=8,
                         speculative={"enabled": True})
    cfg, params = engine.model_config, engine.params
    err, match, draft = {
        "no draft": (DeepSpeedConfigError, "needs a draft model",
                     lambda: None),
        "MoE draft": (NotImplementedError, "dense", _moe_engine),
        "vocabulary": (ValueError, "vocabulary", lambda: (
            dataclasses.replace(cfg, vocab_size=128), params)),
        "short context": (ValueError, "smaller than", lambda: (
            dataclasses.replace(cfg, max_seq_len=32), params)),
    }[case]
    with pytest.raises(err, match=match):
        SlotBatcher(engine, conf, draft=draft())


def _moe_engine():
    """A tiny GPT-MoE engine (the MoE tests' config, the port's init)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt_moe
    from .test_torch_moe_inference import CFG
    cfg = convert.moe_config_from_jax(CFG, dtype=torch.float32)
    return deepspeed_tpu_torch.init_inference(
        (cfg, gpt_moe.init(cfg, torch.Generator().manual_seed(0))),
        {"dtype": "float32"}, device="cpu")


# ------------------------------------------------------------ the gateway

@pytest.mark.parametrize("draft", ["self", "partial", "spec"])
def test_greedy_replies_equal_sequential_sessions(engine, partial_draft,
                                                  serve, draft):
    """10 requests through 3 speculative slots: every reply equals the
    request alone through a session, whatever the draft proposes (the
    target itself: every proposal accepted and windows cut at the budget;
    a half-trained draft; the random geometry-spec draft)."""
    gw, _ = serve(draft={"self": engine, "partial": partial_draft,
                         "spec": None}[draft],
                  spec={"draft": SPEC_DRAFT} if draft == "spec" else None)
    assert gw._batcher.spec and gw._batcher.spec_overshoot == 3
    reqs = _requests(np.random.default_rng(1), 10)
    handles = [gw.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = [h.result(timeout=WAIT_S) for h in handles]
    for (prompt, n), out in zip(reqs, outs):
        assert out.shape == (n,)
        np.testing.assert_array_equal(out, _session_reply(engine, prompt, n))
    snap = gw.snapshot()
    assert snap["completed"] == 10
    assert snap["tokens_out"] == sum(n for _, n in reqs)
    assert snap["spec_rounds"] == snap["ticks"] > 0
    rate = snap["spec_accept_rate_mean"]
    if draft == "self":
        assert rate == 1.0 and snap["ticks"] < snap["tokens_out"] / 2
    else:
        assert 0.0 <= rate < 1.0


def test_eos_cuts_a_window(engine, serve):
    """An eos inside an accepted window ends the reply there, as a
    session's reply cut at its first eos."""
    prompt = np.random.default_rng(5).integers(0, 256, (11,)).astype(
        np.int32)
    ref = _session_reply(engine, prompt, 16)
    eos = int(ref[5])
    cut = ref[:int(np.flatnonzero(ref == eos)[0]) + 1]
    gw, _ = serve(draft=engine)
    out = gw.submit(prompt, max_new_tokens=16,
                    eos_token_id=eos).result(timeout=WAIT_S)
    np.testing.assert_array_equal(out, cut)


def test_overshoot_is_rejected_as_too_long(serve):
    """prompt + budget + draft_k past the slot is ``too_long``, with the
    overshoot in the message; one position less is admitted."""
    gw, journal = serve(draft=None, spec={"draft": SPEC_DRAFT})
    with pytest.raises(ValueError, match=r"speculative overshoot \(3\)"):
        gw.submit(np.zeros((40,), np.int32), max_new_tokens=22)
    assert [e["reason"] for e in journal.read()
            if e["kind"] == EventKind.SERVE_REJECT] == ["too_long"]
    out = gw.submit(np.zeros((40,), np.int32),
                    max_new_tokens=21).result(timeout=WAIT_S)
    assert out.shape == (21,)


@pytest.mark.parametrize("levels", [(1,), (2,), (1, 2, 0, 2, 1, 0)])
def test_spec_levels_keep_the_greedy_chain(engine, partial_draft, levels):
    """``set_spec_level`` between ticks (1: ``draft_k2`` rounds, 2: plain
    ticks, the first flushing the pending token; back to 0: the pending
    tokens redrawn) leaves every slot's tokens equal to its session
    reply."""
    bat = SlotBatcher(engine, ServingConfig(
        slots=3, max_len=128, prefill_chunk=8,
        speculative={"enabled": True, "draft_k": 5}), draft=partial_draft)
    assert (bat.draft_k, bat.draft_k2, bat.spec_overshoot) == (7, 3, 7)
    reqs = _requests(np.random.default_rng(2), 3, hi=30)
    for row, (prompt, _) in enumerate(reqs):
        bat.admit(row, prompt, None, True, 1.0)
    out, i = [[] for _ in reqs], 0
    while bat.active.any():
        live = bat.active.copy()
        bat.set_spec_level(levels[i % len(levels)] if i % 2 else 0)
        res = bat.tick()
        k = bat.round_draft_k
        if isinstance(res, tuple):
            window, counts = res
            assert window.shape == (3, k + 1)
            assert ((counts >= 1) == live).all()
            got = [window[row, :counts[row]].tolist() for row in range(3)]
        else:
            assert k == 0
            got = [[int(res[row])] for row in range(3)]
        for row in np.flatnonzero(live):
            out[row].extend(got[row])
            if len(out[row]) >= 40:
                bat.release(row)
        i += 1
    assert bat.host_reads == i
    for row, (prompt, _) in enumerate(reqs):
        s = engine.start_session(batch=1, max_len=128)
        s.append(prompt[None])
        np.testing.assert_array_equal(
            out[row][:40], s.generate(max_new_tokens=40)[0].numpy())
    with pytest.raises(ValueError, match="0, 1, or 2"):
        bat.set_spec_level(3)


def test_spec_round_journal_and_snapshot_keys(engine, serve):
    """``serve.spec_round`` every ``journal_every_ticks`` with JAX's
    summary fields; the snapshot has JAX's ``spec_*`` keys."""
    gw, journal = serve(draft=engine, journal_every_ticks=1)
    reqs = _requests(np.random.default_rng(3), 4)
    for h in [gw.submit(p, max_new_tokens=n) for p, n in reqs]:
        h.result(timeout=WAIT_S)
    gw.shutdown()
    rounds = [e for e in journal.read()
              if e["kind"] == EventKind.SERVE_SPEC_ROUND]
    snap = gw.snapshot()
    assert len(rounds) == snap["spec_rounds"] == snap["ticks"]
    fields = SUMMARY_FIELDS[EventKind.SERVE_SPEC_ROUND]
    assert all(set(fields) <= set(e) for e in rounds)
    assert all(e["draft_k"] == 3 and e["accept_rate"] == 1.0
               and e["emitted"] >= e["active"] for e in rounds)
    assert sum(e["emitted"] for e in rounds) == snap["tokens_out"]
    jkeys = {k for k in JaxServingMetrics().snapshot() if "spec" in k}
    assert jkeys and jkeys <= set(snap)
    assert snap["spec_accepted"] == snap["spec_proposed"] > 0
    assert gw.metrics.spec_tokens_per_tick.snapshot()["count"] == \
        snap["spec_rounds"]


def test_sampled_replies_repeat_under_a_seed(engine, partial_draft, serve):
    """A sampled request with a seed gives one reply alone, again alone,
    and beside greedy and other sampled requests: a slot's draft and
    accept streams are its own.  Another seed gives another reply."""
    gw, _ = serve(draft=partial_draft, top_k=50)
    prompt = np.arange(3, 15, dtype=np.int32)

    def sampled(seed):
        return gw.submit(prompt, max_new_tokens=16, do_sample=True,
                         temperature=0.8, seed=seed)

    alone = sampled(11).result(timeout=WAIT_S)
    np.testing.assert_array_equal(sampled(11).result(timeout=WAIT_S), alone)
    rng = np.random.default_rng(4)
    others = [gw.submit(p, max_new_tokens=n) for p, n in _requests(rng, 2)]
    mixed = [sampled(11), sampled(12)]
    outs = [h.result(timeout=WAIT_S) for h in mixed + others]
    np.testing.assert_array_equal(outs[0], alone)
    assert not np.array_equal(outs[1], alone)
    assert ((alone >= 0) & (alone < 256)).all()
