"""The port's preemptible run (``elasticity.ElasticTrainRunner`` and
``runtime/supervision/``) against the JAX package's, on TINY_GPT in fp32
from the same params (``convert.from_jax_params``) over the same
``ResumableDataLoader`` geometry (the JAX engine's micro 1 × dp 8 is the
port's micro-batch of 8).

- Runner trajectories: a straight run of each package's runner gives the
  same losses and final master within ``test_torch_training.py``'s 1e-5.
- A tag saved by a preempted JAX runner resumes in the port's runner on
  the exact next batch, and the reverse; both continue the straight run
  within 1e-5 and end with its loader state.
- Within the port: SIGTERM at step 3 on the async engine drains into a
  tag, the newest tag is corrupted, a fresh engine from another seed
  falls back to the step-2 tag and runs to the end: bitwise equal to the
  straight run (every flat buffer, the optimizer's state, the losses, the
  loader state).
- Rollback with quarantine, ``max_rollbacks`` exhausted, nothing verified
  to roll back to, and a watchdog expiry through ``on_expire``: both
  packages' journals hold the same events with the same step fields, and
  their losses agree within 1e-5.
- Heartbeat files and the elastic admission algebra read the same in
  both packages.

One JAX engine is built per module (~8 s, its compile); each case resets
it by loading its initial tag and then runs in well under 2 s.  Every
wait runs through a fault plan with a deadline of its own."""

import dataclasses
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.elasticity import ElasticTrainRunner as JRunner
from deepspeed_tpu.elasticity import compute_elastic_config as jelastic
from deepspeed_tpu.runtime.data_pipeline import ResumableDataLoader as JLoader
from deepspeed_tpu.runtime.supervision import (HeartbeatMonitor as JMonitor,
                                               HeartbeatWriter as JWriter,
                                               read_events as jread)
from deepspeed_tpu.utils import fault_injection as jfi
from deepspeed_tpu_torch.elasticity import ElasticTrainRunner as PRunner
from deepspeed_tpu_torch.elasticity import (ElasticityIncompatibleWorldSize,
                                            compute_elastic_config)
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.data_pipeline import \
    ResumableDataLoader as PLoader
from deepspeed_tpu_torch.runtime.model import from_gpt
from deepspeed_tpu_torch.runtime.supervision import (EventJournal,
                                                     HeartbeatMonitor,
                                                     HeartbeatWriter,
                                                     read_events)
from deepspeed_tpu_torch.utils import fault_injection as pfi
from tests.unit.common import (TINY_GPT, RandomTokenDataset, base_config,
                               make_mesh, tiny_model)

TOL = 1e-5
SEQ = 16
STEPS = 4
OPTIMIZER = {"optimizer": {"type": "Adam",
                           "params": {"lr": 1e-3, "weight_decay": 0.01}}}
#: journal fields that differ between two runs of one scenario (the loss
#: is compared apart: NaN never equals itself)
VOLATILE = ("ts", "seq", "stacks", "loss", "elapsed_s")

JAX = SimpleNamespace(name="jax", Runner=JRunner, Loader=JLoader, fi=jfi,
                      read=jread)
PORT = SimpleNamespace(name="port", Runner=PRunner, Loader=PLoader, fi=pfi,
                       read=read_events)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    jfi.clear()
    pfi.clear()


def _dataset():
    return RandomTokenDataset(48, SEQ, seed=3)


def _loader(pkg):
    return pkg.Loader(_dataset(), 8, shuffle=True, seed=11)


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """One JAX engine and a tag of its initial state; ``reset()`` loads
    the tag (counters, params, moments and LR included)."""
    engine, *_ = deepspeed_tpu.initialize(
        model=tiny_model(), mesh_manager=make_mesh(dp=8),
        config=base_config(micro_batch=1, gas=1, stage=0, extra=OPTIMIZER),
        rng=jax.random.PRNGKey(42))
    init_dir = str(tmp_path_factory.mktemp("jax_init"))
    engine.save_checkpoint(init_dir, tag="init")
    init_master = jax.device_get(engine.state["master"])

    def reset():
        engine.data_iterator = None
        loaded, _ = engine.load_checkpoint(init_dir, tag="init")
        assert loaded is not None and engine.global_steps == 0
        return engine

    # the step's compiles (on the initial state, on a loaded state's
    # arrays, on a reset loss scale's), here and not in the cases
    engine.train_batch_fused(next(iter(_loader(JAX))))
    reset().train_batch_fused(next(iter(_loader(JAX))))
    reset().reset_loss_scale()
    engine.train_batch_fused(next(iter(_loader(JAX))))

    return SimpleNamespace(reset=reset, init_master=init_master)


def _port_engine(jax_engine, seed=None, **extra):
    """A port engine from the JAX engine's initial params (``seed``: from
    the port's own init instead, for an engine a resume overwrites)."""
    spec = from_gpt(convert.config_from_jax(TINY_GPT, dtype=torch.float32))
    if seed is None:
        spec = dataclasses.replace(
            spec, params=convert.from_jax_params(jax_engine.init_master))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, device="cpu",
        generator=torch.Generator().manual_seed(seed or 0),
        config={"train_micro_batch_size_per_gpu": 8, **OPTIMIZER, **extra})
    return engine


def _engine(pkg, jax_engine, seed=None):
    return jax_engine.reset() if pkg is JAX else _port_engine(jax_engine, seed)


def _master(pkg, engine):
    if pkg is JAX:
        return jax.device_get(engine.state["master"])
    return convert.to_numpy_params(engine.state["master"])


def _assert_tree_close(got, want, tol=TOL):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _straight(pkg, jax_engine, tmp_path, steps=STEPS):
    engine = _engine(pkg, jax_engine)
    loader = _loader(pkg)
    res = pkg.Runner(engine, str(tmp_path / f"{pkg.name}_straight"),
                     save_interval=100).run(loader, max_steps=steps,
                                            resume=False)
    return res, _master(pkg, engine), loader.state_dict()


def test_runner_trajectory_matches_jax(jax_engine, tmp_path):
    jres, jmaster, jstate = _straight(JAX, jax_engine, tmp_path)
    pres, pmaster, pstate = _straight(PORT, jax_engine, tmp_path)
    assert pres["steps"] == jres["steps"] == STEPS
    np.testing.assert_allclose(pres["losses"], jres["losses"], rtol=TOL,
                               atol=TOL)
    _assert_tree_close(pmaster, jmaster)
    assert pstate == jstate


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_preempted_tag_resumes_across_packages(jax_engine, tmp_path, src,
                                               dst):
    """SIGTERM at step 2 in one package's runner drains into a tag; a
    fresh engine of the other package resumes from it on the exact next
    batch and continues the straight run."""
    ref, ref_master, ref_state = _straight(JAX, jax_engine, tmp_path)
    save = str(tmp_path / "ck")
    with src.fi.inject("train.step", src.fi.SignalAtStep(2)):
        res = src.Runner(_engine(src, jax_engine), save,
                         save_interval=100).run(_loader(src),
                                                max_steps=STEPS,
                                                resume=False)
    assert res["preempted"] and res["steps"] == 2
    engine = _engine(dst, jax_engine, seed=7)
    loader = _loader(dst)
    journal = str(tmp_path / "resume.jsonl")
    loader.journal = EventJournal(journal)
    res2 = dst.Runner(engine, save, save_interval=100).run(
        loader, max_steps=STEPS - 2)
    restore = read_events(journal, kind="data.iterator_restore")
    assert [(e["step"], e["epoch"], e["batch_index"]) for e in restore] == \
        [(2, 0, 2)]
    np.testing.assert_allclose(res["losses"] + res2["losses"],
                               ref["losses"], rtol=TOL, atol=TOL)
    _assert_tree_close(_master(dst, engine), ref_master)
    assert loader.state_dict() == ref_state
    assert engine.global_steps == STEPS


def _state(engine):
    """Every piece of training state by its path in the checkpoint's tree
    (two engines built from different inits lay their flat buffers out in
    different leaf orders)."""
    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v.clone()
    return dict(walk(engine._checkpoint_state(), ""))


def test_port_preempt_resume_is_bitwise(jax_engine, tmp_path):
    """SIGTERM at step 3 on the async engine (a save at step 2 running in
    the background), the drain's tag corrupted, a fresh engine from
    another seed falls back to the step-2 tag and runs to step 5:
    bitwise equal to the straight run."""
    steps = 5
    sup = {"preempt_save_deadline_s": 60.0}
    straight = _port_engine(jax_engine)
    loader = _loader(PORT)
    ref = PRunner(straight, str(tmp_path / "ref"), save_interval=100).run(
        loader, max_steps=steps, resume=False)
    save = str(tmp_path / "ck")
    engine = _port_engine(jax_engine, checkpoint={"async_save": True})
    with pfi.inject("train.step", pfi.SignalAtStep(3)):
        res = PRunner(engine, save, save_interval=2, supervision=sup).run(
            _loader(PORT), max_steps=steps, resume=False)
    assert res["preempted"] and res["steps"] == 3
    events = read_events(os.path.join(save, "events.jsonl"))
    kinds = [e["kind"] for e in events]
    assert kinds.count("preempt.signal") == 1
    drained = [e for e in events if e["kind"] == "ckpt.preempt_save"]
    assert [(e["step"], e["tag"]) for e in drained] == [(3, "elastic_step3")]
    assert os.path.exists(os.path.join(save, "elastic_step3", "commit.json"))
    pfi.CorruptRandomBytes(match="model_states.npz").fire(
        "ckpt.post_write",
        path=os.path.join(save, "elastic_step3", "model_states.npz"))
    fresh = _port_engine(jax_engine, seed=9)
    fresh_loader = _loader(PORT)
    res2 = PRunner(fresh, save, save_interval=100, supervision=sup).run(
        fresh_loader, max_steps=steps - 2)
    assert res2["steps"] == steps - 2
    assert res["losses"][:2] + res2["losses"] == ref["losses"]
    want, got = _state(straight), _state(fresh)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert fresh_loader.state_dict() == loader.state_dict()


#: scenario -> (runner kwargs, supervision, NaN window, hang, steps,
#: raises).  The watchdog case runs one step: the expiry disarms the
#: guard, so a loaded host cannot add a second expiry on a slow step.
CASES = {
    "rollback_quarantine": (dict(save_interval=2), {"rollback": {
        "max_rollbacks": 2, "lr_factor": 0.5}}, (3, 4), False, 6, False),
    "max_rollbacks_exhausted": (dict(save_interval=2), {"rollback": {
        "max_rollbacks": 1}}, (3, 30), False, 6, True),
    "nothing_verified": (dict(save_interval=100), {"rollback": {
        "max_rollbacks": 2}}, (1, 30), False, 6, True),
    "watchdog": (dict(save_interval=100), {"step_deadline_s": 0.3},
                 None, True, 1, False),
}


def _scenario(pkg, jax_engine, save, case):
    kwargs, sup, nan, hang, steps, raises = CASES[case]
    engine = _engine(pkg, jax_engine)
    runner = pkg.Runner(engine, save, nan_abort_threshold=1,
                        supervision=sup, **kwargs)
    if nan is not None:
        pkg.fi.install("train.loss", pkg.fi.NaNLossWindow(*nan))
    if hang:
        # the hung step is released by the expiry, well inside 10 s
        fault = pkg.fi.install("train.step_begin", pkg.fi.HangFor(10.0))
        runner.watchdog.on_expire = lambda rec: fault.release()
    res = None
    try:
        res = runner.run(_loader(pkg), max_steps=steps, resume=False)
    except RuntimeError as e:
        assert raises and "non-finite" in str(e)
    else:
        assert not raises
    finally:
        pkg.fi.clear()
    events = pkg.read(os.path.join(save, "events.jsonl"))
    return res, events, engine


def _fields(events):
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in events]


@pytest.mark.parametrize("case", list(CASES))
def test_journal_matches_jax(jax_engine, tmp_path, case):
    jres_, jev, jeng = _scenario(JAX, jax_engine, str(tmp_path / "jax"),
                                 case)
    pres_, pev, peng = _scenario(PORT, jax_engine, str(tmp_path / "port"),
                                 case)
    assert _fields(pev) == _fields(jev)
    kinds = [e["kind"] for e in pev]
    if case == "rollback_quarantine":
        assert kinds.count("rollback") == 1
        rb = next(e for e in pev if e["kind"] == "rollback")
        assert (rb["from_step"], rb["to_step"], rb["quarantine"]) == \
            (3, 2, [2, 3])
        q = next(e for e in pev if e["kind"] == "data.quarantine")
        assert (q["from_step"], q["to_step"]) == (2, 3)
        assert "rollback.recovered" in kinds
        np.testing.assert_allclose(pres_["losses"], jres_["losses"],
                                   rtol=TOL, atol=TOL)
        assert math.isnan(pres_["losses"][2])
        assert peng.optimizer.param_groups[0]["lr"] == \
            jeng.optimizer.param_groups[0]["lr"] == 5e-4
        _assert_tree_close(_master(PORT, peng), _master(JAX, jeng))
    elif case == "watchdog":
        wd = [e for e in pev if e["kind"] == "watchdog.expired"]
        assert len(wd) == 1 and wd[0]["label"] == "train.step"
        assert "Thread MainThread" in wd[0]["stacks"]
        np.testing.assert_allclose(pres_["losses"], jres_["losses"],
                                   rtol=TOL, atol=TOL)
    else:
        abort = [e for e in pev if e["kind"] == "divergence.abort"]
        assert len(abort) == 1
        assert abort[0]["reason"] == (
            "max_rollbacks exhausted" if case == "max_rollbacks_exhausted"
            else "no verified checkpoint to roll back to")


def test_heartbeats_read_across_packages(tmp_path):
    """Each package's monitor reads the other's beat files, and ages them
    into the same gap events."""
    d = str(tmp_path / "hb")
    HeartbeatWriter(d, rank=0, interval_s=1.0).beat(step=3)
    JWriter(d, rank=1, interval_s=1.0).beat(step=4)
    now = max(r["ts"] for r in HeartbeatMonitor(d).read_beats().values())
    out = []
    for Monitor, path in ((JMonitor, "jax.jsonl"),
                          (HeartbeatMonitor, "port.jsonl")):
        journal = EventJournal(str(tmp_path / path))
        mon = Monitor(d, gap_s=5.0, journal=journal, expected_ranks=3)
        fresh = mon.check(now=now + 1.0)
        stale = mon.check(now=now + 60.0)
        out.append((fresh["alive"], fresh["missing"],
                    [s["rank"] for s in stale["stale"]],
                    [(e["kind"], e["rank"], e["last_step"])
                     for e in journal.read()]))
    assert out[1] == out[0] == ([0, 1], [2], [0, 1],
                                [("heartbeat.gap", 0, 3),
                                 ("heartbeat.gap", 1, 4)])


@pytest.mark.parametrize("section,world", [
    ({"enabled": True, "max_train_batch_size": 2000,
      "micro_batch_sizes": [2, 4, 6], "min_gpus": 1, "max_gpus": 64}, 8),
    ({"enabled": True, "max_train_batch_size": 512,
      "micro_batch_sizes": [8, 16], "min_gpus": 4, "max_gpus": 32,
      "version": 0.1}, 4),
    ({"enabled": True, "max_train_batch_size": 96, "micro_batch_sizes": [3],
      "max_gpus": 16, "model_parallel_size": 2}, 5),
], ids=["v02", "v01", "mp2_bad_world"])
def test_elastic_admission_matches_jax(section, world):
    cfg = {"elasticity": section}
    try:
        want = jelastic(cfg, world_size=world, return_microbatch=True)
    except Exception as e:                  # noqa: BLE001 — compared below
        with pytest.raises(ElasticityIncompatibleWorldSize) as got:
            compute_elastic_config(cfg, world_size=world,
                                   return_microbatch=True)
        assert str(got.value) == str(e)
        return
    assert compute_elastic_config(cfg, world_size=world,
                                  return_microbatch=True) == want


def test_runner_threads_stop_at_the_end(jax_engine, tmp_path):
    """Heartbeats and the watchdog run only while the runner does: the
    beat file carries the last step, the commit barrier gets the rank-0
    monitor, and both threads are gone when ``run`` returns."""
    save = str(tmp_path / "ck")
    runner = PRunner(_port_engine(jax_engine), save, save_interval=2,
                     supervision={"step_deadline_s": 30.0, "heartbeat": {
                         "enabled": True, "interval_s": 0.05,
                         "gap_s": 5.0}})
    assert isinstance(runner.commit_ctx.heartbeat, HeartbeatMonitor)
    res = runner.run(_loader(PORT), max_steps=2, resume=False)
    assert res["steps"] == 2 and not res["preempted"]
    beats = HeartbeatMonitor(os.path.join(save, "heartbeats")).read_beats()
    assert beats[0]["rank"] == 0 and runner.heartbeat.beats >= 1
    assert runner.heartbeat._thread is None
    assert not runner.watchdog._thread.is_alive()
    assert [e["kind"] for e in read_events(os.path.join(
        save, "events.jsonl"))] == ["ckpt.committed"]
