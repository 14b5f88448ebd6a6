"""The port's checkpoint durability substrate (``deepspeed_tpu_torch.
runtime.checkpoint_engine``, ``utils/fault_injection.py``,
``runtime/supervision/events.py``): the cases of the JAX package's
``tests/unit/checkpoint/test_durability.py`` and ``test_commit_protocol.py``
that need no second process, on toy torch state trees — integrity
manifests, the corruption matrix and the verified-fallback walk, retries
under injected faults, retention, the config section, the ready votes,
commit, torn-tag sweep and the file consensus channel.  Writer threads
stand in for the other ranks.  Plus what only the port has: a load that
copies in place leaves the template untouched when nothing loads, and
refuses an array of the wrong shape."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    CheckpointCorruptionError, DeepSpeedCheckpointConfig,
    NativeCheckpointEngine, list_tags, load_engine_checkpoint,
    newest_verified_tag, prune_checkpoints, resolve_tag,
    save_engine_checkpoint, verify_tag)
from deepspeed_tpu_torch.runtime.checkpoint_engine import commit as cp
from deepspeed_tpu_torch.runtime.checkpoint_engine.async_checkpoint_engine import (
    AsyncCheckpointEngine)
from deepspeed_tpu_torch.runtime.checkpoint_engine.config import (
    CheckpointCommitConfig)
from deepspeed_tpu_torch.runtime.checkpoint_engine.integrity import MANIFEST
from deepspeed_tpu_torch.runtime.checkpoint_engine.storage import (
    atomic_write_npz)
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.supervision.events import (EventJournal,
                                                            EventKind,
                                                            read_events)
from deepspeed_tpu_torch.utils import fault_injection as fi

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    fi.clear()


def tree(v, acc=0.0):
    """A minimal engine-shaped state tree whose params encode ``v``."""
    def a():
        return torch.tensor(float(v))
    return {"params": {"w": a(), "b": torch.full((4,), float(v))},
            "master": {"w": a(), "b": torch.full((4,), float(v))},
            "opt_state": {"m": {"w": a() * 0.1}, "v": {"w": a() * 0.2}},
            "grad_acc": {"w": torch.tensor(float(acc))},
            "scale": {"loss_scale": torch.tensor(1024.0)}}


def save_steps(d, steps, config=None, **kw):
    for s in steps:
        save_engine_checkpoint(str(d), f"global_step{s}", tree(s),
                               {"global_steps": s}, separate_master=True,
                               config=config, **kw)


def loaded_step(d, tag=None, config=None):
    st, cs = load_engine_checkpoint(str(d), tag, tree(-1), config=config)
    if st is None:
        return None
    # the restored params must match the step the tag was written at
    assert float(st["params"]["w"]) == cs["global_steps"]
    assert torch.equal(st["master"]["b"],
                       torch.full((4,), float(cs["global_steps"])))
    return cs["global_steps"]


def fast_cfg(**kw):
    kw.setdefault("barrier_deadline_s", 0.4)
    kw.setdefault("barrier_poll_s", 0.01)
    kw.setdefault("barrier_backoff_max_s", 0.05)
    kw.setdefault("consensus_deadline_s", 2.0)
    return CheckpointCommitConfig(**kw)


def ctx(world, rank=0, journal=None, heartbeat=None, channel=None, **cfgkw):
    return cp.CommitContext(world_size=world, rank=rank,
                            config=fast_cfg(**cfgkw), journal=journal,
                            heartbeat=heartbeat, channel=channel)


def save(d, step, commit_ctx=None, tag=None, config=None):
    save_engine_checkpoint(str(d), tag or f"global_step{step}", tree(step),
                           {"global_steps": step}, separate_master=True,
                           config=config, commit_ctx=commit_ctx)


def write_shard(d, tag, rank, world=2):
    """A non-coordinator writer's contribution: shard file + ready vote."""
    atomic_write_npz(os.path.join(str(d), tag, f"shard_rank{rank}.npz"),
                     {"w": np.full((4,), float(rank))})
    cp.write_rank_manifest(str(d), tag, rank, world_size=world)


def latest(d):
    p = os.path.join(str(d), "latest")
    return open(p).read().strip() if os.path.exists(p) else None


# ------------------------------------------------------------- manifests

def test_manifest_written_at_publish_and_verifies(tmp_path):
    save_steps(tmp_path, [7])
    doc = json.loads((tmp_path / "global_step7" / MANIFEST).read_text())
    assert doc["version"] == 1 and doc["tag"] == "global_step7"
    assert doc["step"] == 7
    for f in ("model_states.npz", "optim_states.npz", "client_state.json"):
        assert doc["files"][f]["bytes"] == os.path.getsize(
            tmp_path / "global_step7" / f)
        assert len(doc["files"][f]["sha256"]) == 64
    assert verify_tag(str(tmp_path), "global_step7") == (True, [])


def test_resolve_tag_helper(tmp_path):
    assert resolve_tag(str(tmp_path), None) is None
    assert resolve_tag(str(tmp_path), "pinned") == "pinned"
    (tmp_path / "latest").write_text("global_step3")
    assert resolve_tag(str(tmp_path), None) == "global_step3"
    assert resolve_tag(str(tmp_path), "pinned") == "pinned"


# ----------------------------------------------------- corruption matrix

def _truncate_newest(d):
    p = d / "global_step3" / "model_states.npz"
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)


def _flip_bytes_newest(d):
    fi.corrupt_file(str(d / "global_step3" / "optim_states.npz"))


def _drop_manifest_newest(d):
    os.remove(d / "global_step3" / MANIFEST)


def _stale_latest(d):
    import shutil
    shutil.rmtree(d / "global_step3")      # latest still names it


def _torn_newest(d):
    os.remove(cp.commit_path(str(d), "global_step3"))


@pytest.mark.parametrize("corrupt,commit", [
    (_truncate_newest, False), (_flip_bytes_newest, False),
    (_drop_manifest_newest, False), (_stale_latest, False),
    (_torn_newest, True)],
    ids=["truncated-npz", "flipped-bytes", "missing-manifest",
         "stale-latest", "torn-advertised"])
def test_corruption_matrix_falls_back_to_newest_verified(tmp_path, corrupt,
                                                         commit):
    """Every corruption mode is caught and resume lands on the newest tag
    that still verifies — never a hard failure, never a silent
    non-resume; a torn tag (votes without ``commit.json``) even when
    ``latest`` advertises it."""
    for s in (1, 2, 3):
        save(tmp_path, s, commit_ctx=ctx(1) if commit else None)
    corrupt(tmp_path)
    assert latest(tmp_path) == "global_step3"
    assert loaded_step(tmp_path) == 2


def test_two_corrupt_tags_fall_back_twice(tmp_path):
    save_steps(tmp_path, [1, 2, 3])
    fi.corrupt_file(str(tmp_path / "global_step3" / "model_states.npz"))
    fi.corrupt_file(str(tmp_path / "global_step2" / "optim_states.npz"))
    assert loaded_step(tmp_path) == 1


def test_all_tags_corrupt_returns_none_and_leaves_state(tmp_path):
    """Nothing loads: ``(None, {})``, and the template (the engine's live
    buffers) is untouched — the walk reads and checks a tag whole before
    it copies anything."""
    save_steps(tmp_path, [1, 2])
    for t in ("global_step1", "global_step2"):
        fi.corrupt_file(str(tmp_path / t / "model_states.npz"))
    live = tree(-1)
    st, cs = load_engine_checkpoint(str(tmp_path), None, live)
    assert st is None and cs == {}
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(live), _leaves(tree(-1))))


def test_empty_dir_returns_none(tmp_path):
    st, cs = load_engine_checkpoint(str(tmp_path), None, tree(-1))
    assert st is None and cs == {}


def _leaves(t):
    return [x for v in t.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("pinned", ["corrupt", "torn"])
def test_explicit_tag_corruption_raises(tmp_path, pinned):
    """A pinned tag that fails verification (or is torn) must raise, not
    silently swap; the intact pinned tag still loads."""
    save(tmp_path, 1, commit_ctx=ctx(1))
    save(tmp_path, 2, commit_ctx=ctx(1))
    if pinned == "corrupt":
        fi.corrupt_file(str(tmp_path / "global_step2" / "model_states.npz"))
        match = "sha256"
    else:
        os.remove(cp.commit_path(str(tmp_path), "global_step2"))
        match = "torn"
    with pytest.raises(CheckpointCorruptionError, match=match):
        load_engine_checkpoint(str(tmp_path), "global_step2", tree(-1))
    assert loaded_step(tmp_path, tag="global_step1") == 1


@pytest.mark.parametrize("no_protocol", [False, True],
                         ids=["preintegrity", "precommit"])
def test_older_layouts_still_load(tmp_path, no_protocol):
    """Back-compat: a tag written before the integrity subsystem (no
    manifest anywhere), and one written before the commit protocol (no
    votes, no commit), load as before."""
    save(tmp_path, 5)
    if no_protocol:
        assert not cp.uses_commit_protocol(str(tmp_path), "global_step5")
        assert cp.commit_status(str(tmp_path), "global_step5")["verdict"] \
            == "pre-commit"
    else:
        os.remove(tmp_path / "global_step5" / MANIFEST)
    assert loaded_step(tmp_path) == 5


def test_wrong_shape_is_rejected_before_any_copy(tmp_path):
    """An array whose shape differs from its template's would broadcast
    silently under an in-place copy: the tag is refused (pinned: raises;
    walked: skipped), and nothing of the template changes."""
    save_steps(tmp_path, [1])
    bigger = tree(-1)
    bigger["params"]["b"] = torch.zeros(5)
    bigger["master"]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="params/b"):
        load_engine_checkpoint(str(tmp_path), "global_step1", bigger)
    st, _ = load_engine_checkpoint(str(tmp_path), None, bigger)
    assert st is None and float(bigger["params"]["w"]) == -1.0


# ------------------------------------------------------ retrying storage

@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_writer_retries_transient_failure(tmp_path, async_save):
    eng = AsyncCheckpointEngine({"retries": {"backoff_base": 0.001}}) \
        if async_save else None
    with fi.inject("ckpt.write", fi.FailNTimes(2, match="optim_states")) as f:
        save_steps(tmp_path, [4], engine=eng)
        if eng is not None:
            eng.wait()     # joins writers + the publish chain: no raise
    assert f.fired == 2
    assert latest(tmp_path) == "global_step4"
    assert verify_tag(str(tmp_path), "global_step4")[0]
    assert loaded_step(tmp_path) == 4


def test_sync_writer_permanent_failure_raises_and_leaves_no_half_file(tmp_path):
    cfg = DeepSpeedCheckpointConfig.from_dict(
        {"retries": {"max_attempts": 2, "backoff_base": 0.001}})
    with fi.inject("ckpt.write", fi.FailNTimes(None, match="model_states")):
        with pytest.raises(fi.FaultError):
            save_steps(tmp_path, [1], config=cfg)
    d = tmp_path / "global_step1"
    assert not (d / "model_states.npz").exists()
    assert not list(d.glob("*.tmp"))
    assert latest(tmp_path) is None


def test_async_writer_permanent_failure_blocks_publication(tmp_path):
    eng = AsyncCheckpointEngine(
        {"retries": {"max_attempts": 2, "backoff_base": 0.001}})
    with fi.inject("ckpt.write", fi.FailNTimes(None, match="model_states")):
        save_steps(tmp_path, [4], engine=eng)
        with pytest.raises(RuntimeError, match="async checkpoint write"):
            eng.wait()
    # the tag whose bytes never landed must not look saved
    assert latest(tmp_path) is None
    assert not verify_tag(str(tmp_path), "global_step4")[0]
    # ...and the pool is not poisoned: the next save lands end to end
    save_steps(tmp_path, [5], engine=eng)
    eng.wait()
    assert latest(tmp_path) == "global_step5"
    assert loaded_step(tmp_path) == 5


def test_sync_save_atomic_and_bare_filename(tmp_path, monkeypatch):
    """A bare filename (empty dirname) must not crash on
    ``os.makedirs('')``; bf16 widens to fp32 in the file."""
    monkeypatch.chdir(tmp_path)
    eng = NativeCheckpointEngine()
    eng.save({"w": torch.ones(2, dtype=torch.bfloat16)}, "bare_file")
    assert os.path.exists("bare_file.npz")
    got = eng.load("bare_file")
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], np.ones((2,)))


# ------------------------------------------------------------- retention

def test_keep_last_prunes_after_publish(tmp_path):
    cfg = DeepSpeedCheckpointConfig.from_dict({"keep_last": 2})
    save_steps(tmp_path, [1, 2, 3, 4], config=cfg)
    assert list_tags(str(tmp_path)) == ["global_step4", "global_step3"]
    assert loaded_step(tmp_path) == 4


def test_retention_never_deletes_newest_verified_tag(tmp_path):
    save_steps(tmp_path, [1, 2, 3])
    fi.corrupt_file(str(tmp_path / "global_step3" / "model_states.npz"))
    assert newest_verified_tag(str(tmp_path)) == "global_step2"
    # step3 survives as the keep_last newest, step2 as the newest
    # verified; only step1 is prunable
    assert prune_checkpoints(str(tmp_path), keep_last=1) == ["global_step1"]
    assert loaded_step(tmp_path) == 2


def test_keep_last_zero_or_none_keeps_everything(tmp_path):
    save_steps(tmp_path, [1, 2, 3])
    assert prune_checkpoints(str(tmp_path), keep_last=None) == []
    assert prune_checkpoints(str(tmp_path), keep_last=0) == []
    assert len(list_tags(str(tmp_path))) == 3


def test_retention_sweeps_torn_tags(tmp_path):
    """keep_last retention runs the torn sweep: shard-only corpses don't
    accumulate across preemptions."""
    cfg = DeepSpeedCheckpointConfig(keep_last=2)
    write_shard(tmp_path, "global_step1", 1)       # torn corpse
    os.utime(tmp_path / "global_step1", (1.0, 1.0))
    for s in (2, 3):
        save(tmp_path, s, commit_ctx=ctx(1), config=cfg)
    assert not os.path.isdir(tmp_path / "global_step1")
    assert cp.is_committed(str(tmp_path), "global_step3")


# ------------------------------------------------------------ config

@pytest.mark.parametrize("section", [
    {"retries": {"max_attempts": 0}}, {"tag_validation": "explode"},
    {"writers": 0}, {"retries": {"jitter": -1}},
    {"commit": {"barrier_deadline_s": 0}}, {"commit": {"sweep_min_age_s": -1}},
    {"no_such_key": 1}],
    ids=["max_attempts", "tag_validation", "writers", "jitter",
         "barrier_deadline", "sweep_min_age", "unknown_key"])
def test_checkpoint_config_validation(section):
    cfg = DeepSpeedCheckpointConfig.from_dict({})
    assert cfg.integrity and cfg.verify_on_load and not cfg.async_save
    assert cfg.retry.max_attempts == 3 and cfg.commit_config.enabled
    cfg = DeepSpeedCheckpointConfig.from_dict(
        {"keep_last": 4, "retries": {"max_attempts": 7, "jitter": 0.5}})
    assert cfg.keep_last == 4 and cfg.retry.max_attempts == 7
    assert DeepSpeedCheckpointConfig.from_dict({"keep_last": 0}).keep_last \
        is None
    with pytest.raises(ValueError):
        DeepSpeedCheckpointConfig.from_dict(section)
    # through the engine config, the same fault is a DeepSpeedConfigError
    with pytest.raises(DeepSpeedConfigError, match="checkpoint"):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1,
                         "checkpoint": section})


def test_config_section_parses_through_deepspeed_config():
    cfg = DeepSpeedConfig({
        "train_micro_batch_size_per_gpu": 1,
        "checkpoint": {"keep_last": 3, "async_save": False,
                       "retries": {"max_attempts": 5},
                       "tag_validation": "FAIL"},
    })
    assert cfg.checkpoint_config.keep_last == 3
    assert cfg.checkpoint_config.retry.max_attempts == 5
    assert cfg.checkpoint_tag_validation_mode == "Fail"
    assert cfg.checkpoint_tag_validation_enabled
    assert cfg.checkpoint_tag_validation_fail
    assert not cfg.load_universal_checkpoint


# --------------------------------------------------------------- phase 1/2

def test_single_host_save_publishes_commit_before_latest(tmp_path):
    j = EventJournal(str(tmp_path / "events.jsonl"))
    save(tmp_path, 5, commit_ctx=ctx(1, journal=j))
    tag = "global_step5"
    assert cp.is_committed(str(tmp_path), tag)
    assert latest(tmp_path) == tag
    doc = cp.read_commit(str(tmp_path), tag)
    assert doc["world_size"] == 1 and doc["ranks"] == [0]
    assert "manifest_sha256" in doc    # the commit pins the manifest
    assert cp.read_rank_manifest(str(tmp_path), tag, 0)["rank"] == 0
    kinds = [e["kind"] for e in read_events(j.path)]
    assert EventKind.CKPT_COMMITTED in kinds
    assert loaded_step(tmp_path) == 5


def test_multiwriter_all_ranks_succeed(tmp_path):
    """N writers (threads for ranks 1, 2), everyone votes, commit."""
    tag = "global_step9"

    def writer(rank):
        time.sleep(0.03 * rank)  # stagger: the coordinator polls meanwhile
        write_shard(tmp_path, tag, rank)

    threads = [threading.Thread(target=writer, args=(r,)) for r in (1, 2)]
    for t in threads:
        t.start()
    save(tmp_path, 9, commit_ctx=ctx(3))
    for t in threads:
        t.join()
    assert latest(tmp_path) == tag
    st = cp.commit_status(str(tmp_path), tag)
    assert st["verdict"] == "committed" and st["ready_ranks"] == [0, 1, 2]
    for r in (1, 2):   # each rank's vote hashes exactly its own shard
        m = cp.read_rank_manifest(str(tmp_path), tag, r)
        assert list(m["files"]) == [f"shard_rank{r}.npz"]


@pytest.mark.parametrize("straggle_s", [None, 0.8],
                         ids=["killed", "straggler"])
def test_missing_vote_never_advances_latest(tmp_path, straggle_s):
    """A rank that dies before voting, or votes after the coordinator
    abandoned the tag, cannot let ``latest`` advance to the torn tag;
    resume falls back past it, and the startup sweep quarantines it once
    (idempotent)."""
    j = EventJournal(str(tmp_path / "events.jsonl"))
    tag = "global_step2"
    save(tmp_path, 1, commit_ctx=ctx(1))
    t = None
    if straggle_s is not None:
        t = threading.Thread(target=lambda: (time.sleep(straggle_s),
                                             write_shard(tmp_path, tag, 1)))
        t.start()
    save(tmp_path, 2, commit_ctx=ctx(2, journal=j))
    if t is not None:
        t.join()
    assert latest(tmp_path) == "global_step1"
    assert cp.is_torn(str(tmp_path), tag)
    evs = read_events(j.path, kind=EventKind.CKPT_COMMIT_TIMEOUT)
    assert len(evs) == 1 and evs[0]["missing_ranks"] == [1]
    assert loaded_step(tmp_path) == 1
    assert cp.sweep_torn_tags(str(tmp_path), journal=j) == [tag]
    assert not os.path.isdir(tmp_path / tag)
    assert cp.sweep_torn_tags(str(tmp_path), journal=j) == []
    evs = read_events(j.path, kind=EventKind.CKPT_TORN_TAG)
    assert len(evs) == 1 and evs[0]["tag"] == tag


def test_coordinator_dies_between_ready_and_commit(tmp_path):
    """All votes in, coordinator killed before commit.json: no commit, no
    latest move, torn tag quarantined on restart."""
    save(tmp_path, 1, commit_ctx=ctx(1))
    with fi.inject("ckpt.publish_commit", fi.FailNTimes(None)):
        with pytest.raises(fi.FaultError):
            save(tmp_path, 4, commit_ctx=ctx(1))
    tag = "global_step4"
    assert not cp.is_committed(str(tmp_path), tag)
    assert latest(tmp_path) == "global_step1"
    assert cp.is_torn(str(tmp_path), tag)
    assert cp.sweep_torn_tags(str(tmp_path)) == [tag]
    assert loaded_step(tmp_path) == 1


def test_publish_fault_leaves_tag_committed_but_unadvertised(tmp_path):
    """A fault just before the ``latest`` marker: the tag is committed
    and verifies, the marker stays on the previous tag, and resume takes
    the tag the marker advertises."""
    save(tmp_path, 1, commit_ctx=ctx(1))
    with fi.inject("ckpt.publish", fi.FailNTimes(None)) as f:
        with pytest.raises(fi.FaultError):
            save(tmp_path, 2, commit_ctx=ctx(1))
    assert f.fired == 1
    assert latest(tmp_path) == "global_step1"
    assert cp.is_committed(str(tmp_path), "global_step2")
    assert verify_tag(str(tmp_path), "global_step2")[0]
    assert loaded_step(tmp_path) == 1


def test_commit_refuses_corrupt_rank_shard(tmp_path):
    """A shard that rotted between vote and barrier completion blocks the
    commit marker — the tag is abandoned, never advertised."""
    tag = "global_step7"
    write_shard(tmp_path, tag, 1)
    fi.corrupt_file(str(tmp_path / tag / "shard_rank1.npz"))
    save(tmp_path, 7, commit_ctx=ctx(2))           # must not raise
    assert not cp.is_committed(str(tmp_path), tag)
    assert latest(tmp_path) is None
    with pytest.raises(cp.CheckpointCommitError, match="sha256 mismatch"):
        cp.publish_commit(str(tmp_path), tag, 2)


def test_heartbeat_dead_rank_fails_barrier_immediately(tmp_path):
    class DeadRank1Monitor:
        def check(self, now=None):
            return {"alive": [0], "stale": [], "missing": [1]}

    j = EventJournal(str(tmp_path / "events.jsonl"))
    t0 = time.monotonic()
    save(tmp_path, 2, commit_ctx=ctx(2, journal=j,
                                     heartbeat=DeadRank1Monitor(),
                                     barrier_deadline_s=30.0))
    assert time.monotonic() - t0 < 5.0             # nowhere near 30 s
    evs = read_events(j.path, kind=EventKind.CKPT_COMMIT_TIMEOUT)
    assert len(evs) == 1
    assert evs[0]["dead_ranks"] == [1] and evs[0]["missing_ranks"] == [1]
    assert "dead" in evs[0]["reason"]
    assert latest(tmp_path) is None


def test_barrier_tolerates_broken_monitor(tmp_path):
    class BrokenMonitor:
        def check(self, now=None):
            raise RuntimeError("monitor exploded")

    save(tmp_path, 2, commit_ctx=ctx(1, heartbeat=BrokenMonitor()))
    assert cp.is_committed(str(tmp_path), "global_step2")


def test_straggler_delay_inside_deadline_commits(tmp_path):
    """``DelaySeconds`` at ``ckpt.rank_write`` (a slow rank 1) inside the
    barrier's deadline still commits."""
    tag = "global_step3"
    with fi.inject("ckpt.rank_write", fi.DelaySeconds(0.1, match="rank1")) as f:
        t = threading.Thread(target=write_shard, args=(tmp_path, tag, 1))
        t.start()
        save(tmp_path, 3, commit_ctx=ctx(2, barrier_deadline_s=5.0))
        t.join()
    assert f.fired == 1
    assert cp.commit_status(str(tmp_path), tag)["verdict"] == "committed"
    assert latest(tmp_path) == tag


# -------------------------------------------------------------- consensus

def test_consensus_trivial_single_host(tmp_path):
    j = EventJournal(str(tmp_path / "events.jsonl"))
    save(tmp_path, 5, commit_ctx=ctx(1))
    assert cp.agree_resume_tag(str(tmp_path), ctx(1, journal=j)) == \
        "global_step5"
    evs = read_events(j.path, kind=EventKind.CKPT_RESUME_CONSENSUS)
    assert evs and evs[0]["tag"] == "global_step5" and evs[0]["step"] == 5


def test_consensus_skips_uncommitted_and_corrupt(tmp_path):
    for s in (4, 5, 6):
        save(tmp_path, s, commit_ctx=ctx(1))
    os.remove(cp.commit_path(str(tmp_path), "global_step6"))
    fi.corrupt_file(str(tmp_path / "global_step5" / "model_states.npz"))
    assert cp.local_commit_proposal(str(tmp_path)) == (4, "global_step4")


def _host(load_dir, shared, rank, world, out, journal=None):
    ch = cp.FileConsensusChannel(str(shared), rank, world, deadline_s=5.0,
                                 poll_s=0.01)
    try:
        out[rank] = cp.agree_resume_tag(
            str(load_dir), ctx(world, rank=rank, journal=journal, channel=ch))
    except Exception as e:
        out[rank] = e


def _two_hosts(tmp_path, steps_a, steps_b):
    a, b, shared = tmp_path / "a", tmp_path / "b", tmp_path / "shared"
    for d, steps in ((a, steps_a), (b, steps_b)):
        os.makedirs(d, exist_ok=True)
        for s in steps:
            save(d, s, commit_ctx=ctx(1))
    ja = EventJournal(str(tmp_path / "ja.jsonl"), rank=0)
    out = {}
    tb = threading.Thread(target=_host, args=(b, shared, 1, 2, out))
    tb.start()
    _host(a, shared, 0, 2, out, journal=ja)
    tb.join()
    return out, ja


def test_consensus_divergent_newest_tags_agree_on_min(tmp_path):
    """Host A committed steps 100 and 200; host B's disk has only 100.
    Both agree on 100."""
    out, ja = _two_hosts(tmp_path, (100, 200), (100,))
    assert out == {0: "global_step100", 1: "global_step100"}
    ev = read_events(ja.path, kind=EventKind.CKPT_RESUME_CONSENSUS)[0]
    assert ev["local_step"] == 200 and ev["step"] == 100


@pytest.mark.parametrize("steps_b,reason", [
    ((), "no resumable tag"), ((100,), "missing or corrupt")],
    ids=["peer_has_nothing", "agreed_tag_missing_locally"])
def test_consensus_aborts_loudly(tmp_path, steps_b, reason):
    """Host A has only step 200.  A peer with an empty disk, or one whose
    (min) step 100 A lacks, makes A abort rather than fork the group;
    the peer's own answer stands."""
    out, ja = _two_hosts(tmp_path, (200,), steps_b)
    assert isinstance(out[0], cp.ResumeConsensusError)
    assert out[1] == (f"global_step{steps_b[0]}" if steps_b else None)
    evs = read_events(ja.path, kind=EventKind.CKPT_CONSENSUS_FAILURE)
    assert evs and reason in evs[0]["reason"]


def test_file_channel_round_isolation_and_timeout(tmp_path):
    """Round 2 must not read round 1's proposals; a peer that never
    proposes is a loud deadline abort."""
    shared = tmp_path / "shared"
    a = cp.FileConsensusChannel(str(shared), 0, 2, deadline_s=5.0,
                                poll_s=0.01)
    b = cp.FileConsensusChannel(str(shared), 1, 2, deadline_s=5.0,
                                poll_s=0.01)
    res = {}
    for va, vb, want in ((3, 7, 3), (30, 20, 20)):
        t = threading.Thread(target=lambda v=vb: res.update(b=b.agree_min(v)))
        t.start()
        assert a.agree_min(va) == want
        t.join()
        assert res["b"] == want
    lone = cp.FileConsensusChannel(str(tmp_path / "lone"), 0, 2,
                                   deadline_s=0.2, poll_s=0.01)
    with pytest.raises(cp.ResumeConsensusError, match="timed out"):
        lone.agree_min(1)
    ch = cp.FileConsensusChannel(str(shared), 0, 1, deadline_s=1.0)
    assert ch.agree_min(4) == 4
    ch.sweep_rounds()                      # startup: stale rounds cleared
    assert not os.path.isdir(shared)


def test_collective_channel_refuses_more_than_one_process():
    """The comm layer is not ported: a world of one agrees with itself,
    a larger one raises naming the ROADMAP item."""
    assert cp.CollectiveConsensusChannel(world_size=1).agree_min(9) == 9
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        cp.CollectiveConsensusChannel(world_size=2)


# ------------------------------------------------------------ cross-engine

@pytest.mark.parametrize("world", [1, 2], ids=["committed", "abandoned"])
def test_async_commit_chain(tmp_path, world):
    """The async engine runs the whole commit chain (barrier included) in
    its writer pool: at world 1 the tag commits and a sync load resumes
    it; at world 2 the barrier expires, which is graceful degradation (no
    error at ``wait``, ``latest`` unmoved, the tag torn)."""
    j = EventJournal(str(tmp_path / "events.jsonl"))
    cfg = DeepSpeedCheckpointConfig(async_save=True)
    eng = AsyncCheckpointEngine(cfg)
    save_engine_checkpoint(str(tmp_path), "global_step8", tree(8),
                           {"global_steps": 8}, separate_master=True,
                           engine=eng, config=cfg,
                           commit_ctx=ctx(world, journal=j))
    eng.wait()
    if world == 1:
        assert cp.is_committed(str(tmp_path), "global_step8")
        assert latest(tmp_path) == "global_step8"
        assert loaded_step(tmp_path) == 8
        kinds = [e["kind"] for e in read_events(j.path)]
        assert EventKind.CKPT_COMMITTED in kinds
    else:
        assert latest(tmp_path) is None
        assert cp.is_torn(str(tmp_path), "global_step8")


def test_async_snapshot_owns_its_bytes(tmp_path):
    """``save`` returns after a host copy: a write to the live tensors
    right after it (the next step, in place) does not reach the file."""
    cfg = DeepSpeedCheckpointConfig(async_save=True)
    eng = AsyncCheckpointEngine(cfg)
    live = tree(3)
    with fi.inject("ckpt.write", fi.DelaySeconds(0.2, n=1)):
        save_engine_checkpoint(str(tmp_path), "global_step3", live,
                               {"global_steps": 3}, separate_master=True,
                               engine=eng, config=cfg)
        for t in _leaves(live):
            t.fill_(99.0)
        eng.wait()
    assert loaded_step(tmp_path) == 3


def test_journal_skips_torn_lines(tmp_path):
    j = EventJournal(str(tmp_path / "events.jsonl"), rank=3)
    j.emit(EventKind.CKPT_COMMITTED, tag="t", world_size=1)
    with open(j.path, "a") as f:
        f.write('{"kind": "ckpt.torn_tag", "tag"\n[1, 2]\n')
    j.emit(EventKind.CKPT_TORN_TAG, tag="u", ready_ranks=[0])
    evs = j.read()
    assert [e["kind"] for e in evs] == [EventKind.CKPT_COMMITTED,
                                        EventKind.CKPT_TORN_TAG]
    assert [e["seq"] for e in evs] == [1, 2] and evs[0]["rank"] == 3
    assert read_events(j.path, kind=EventKind.CKPT_TORN_TAG)[0]["tag"] == "u"
