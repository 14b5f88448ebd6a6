"""The port's data pipeline (``runtime/dataloader.py``,
``runtime/data_pipeline/``) against the JAX package's.

- The same dataset, seed and geometry give the same batch indices,
  fingerprints and batches, bitwise, over 3 epochs, with and without
  shuffling and ``drop_last``; ``skip_to`` and ``set_epoch`` agree.
- A loader's ``state_dict`` (through JSON, as a checkpoint carries it)
  loads in the other package, in both directions, and the two continue
  with the same batches.
- Quarantine windows (merged, skipped once per crossing) and the
  bad-record budget (skip, then ``BadRecordBudgetError``) give the same
  yielded steps and the same journal events (kinds and fields, without
  timestamps) in both packages.
- ``initialize(training_data=...)`` builds the loader ``deepspeed_io``
  builds in the JAX engine, and the port's checkpoints carry its
  position in ``client_state["data_iterator"]``.

No engine of the JAX package is built here: every case takes well under
a second."""

import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime.data_pipeline import resumable as jres
from deepspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JDeepSpeedDataLoader
from deepspeed_tpu.runtime.supervision.events import EventJournal as JJournal
from deepspeed_tpu.utils import fault_injection as jfi
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.data_pipeline import resumable as pres
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.model import from_gpt
from deepspeed_tpu_torch.runtime.supervision.events import (EventJournal,
                                                            read_events)
from deepspeed_tpu_torch.utils import fault_injection as pfi
from tests.unit.common import TINY_GPT, RandomTokenDataset

SEQ = 16
#: fields a journal record carries that differ between two runs
VOLATILE = ("ts", "seq", "error")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    jfi.clear()
    pfi.clear()


def _dataset(n=40):
    return RandomTokenDataset(n, SEQ, seed=5)


def _pair(n=40, batch=8, **kw):
    ds = _dataset(n)
    return (jres.ResumableDataLoader(ds, batch, **kw),
            pres.ResumableDataLoader(ds, batch, **kw))


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, True), (False, False)])
def test_batches_match_jax_over_three_epochs(shuffle, drop_last):
    jl, pl = _pair(n=37, shuffle=shuffle, seed=11, drop_last=drop_last)
    assert len(pl) == len(jl)
    for step in range(3 * len(jl)):
        np.testing.assert_array_equal(pl.batch_indices(step),
                                      jl.batch_indices(step))
        assert pl.batch_fingerprint(step) == jl.batch_fingerprint(step)
        _assert_batches_equal(next(pl), next(jl))
        assert pl.state_dict() == jl.state_dict()
    assert pl.epoch == jl.epoch == 3


def test_skip_to_and_set_epoch_match_jax():
    jl, pl = _pair(shuffle=True, seed=3)
    for loader in (jl, pl):
        loader.quarantine(4, 7)
        loader.skip_to(3)
    assert pl.state_dict() == jl.state_dict()
    for _ in range(4):      # steps 3, 7, 8, 9: past the window, epoch 1
        _assert_batches_equal(next(pl), next(jl))
    assert pl.state_dict() == jl.state_dict() and pl.step == 10
    for loader in (jl, pl):
        loader.set_epoch(3)
    assert pl.step == jl.step == 15
    assert pl.samples_consumed == jl.samples_consumed


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_resumes_across_packages(direction):
    """A position saved by one package (JSON, as ``client_state`` holds
    it) continues in the other with the same batches and state."""
    jl, pl = _pair(shuffle=True, seed=9)
    src, dst_cls = (jl, pres.ResumableDataLoader) if \
        direction == "jax_to_port" else (pl, jres.ResumableDataLoader)
    src.quarantine(6, 8)
    for _ in range(4):
        next(src)
    sd = json.loads(json.dumps(src.state_dict()))
    dst = dst_cls(_dataset(), 8, shuffle=True, seed=0)
    dst.load_state_dict(sd)
    assert dst.state_dict() == src.state_dict()
    for _ in range(8):      # across the window and into the next epoch
        _assert_batches_equal(next(dst), next(src))
        assert dst.state_dict() == src.state_dict()


def test_geometry_mismatch_raises_like_jax():
    jl, pl = _pair(shuffle=True)
    sd = jl.state_dict()
    jbad = jres.ResumableDataLoader(_dataset(), 4, shuffle=True)
    pbad = pres.ResumableDataLoader(_dataset(), 4, shuffle=True)
    with pytest.raises(ValueError) as want:
        jbad.load_state_dict(sd)
    with pytest.raises(ValueError) as got:
        pbad.load_state_dict(sd)
    assert str(got.value) == str(want.value)
    newer = dict(sd, version=pres.STATE_VERSION + 1)
    with pytest.raises(ValueError, match="newer"):
        pl.load_state_dict(newer)


def _events(path):
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in read_events(path)]


def _drain(loader, n):
    steps = []
    for _ in range(n):
        step = loader.step
        while loader._window_containing(step) is not None:
            step += 1
        next(loader)
        steps.append(step)
    return steps


def test_quarantine_matches_jax(tmp_path):
    """Overlapping windows merge; the loader skips each window once per
    crossing and journals it; a restore journals the position."""
    jl, pl = _pair(shuffle=True, seed=4)
    jl.journal = JJournal(str(tmp_path / "jax.jsonl"))
    pl.journal = EventJournal(str(tmp_path / "port.jsonl"))
    for loader in (jl, pl):
        loader.quarantine(2, 4)
        loader.quarantine(3, 6)
        loader.quarantine(9, 10)
    assert pl.quarantine_windows == jl.quarantine_windows == [(2, 6), (9, 10)]
    assert _drain(pl, 8) == _drain(jl, 8)
    for loader in (jl, pl):
        loader.load_state_dict(loader.state_dict())
    got, want = _events(pl.journal.path), _events(jl.journal.path)
    assert got == want
    assert [e["kind"] for e in got] == ["data.quarantine.skip"] * 2 + \
        ["data.iterator_restore"]


@pytest.mark.parametrize("budget", [2, 1])
def test_bad_records_match_jax(tmp_path, budget):
    """Two bad batches: a budget of 2 skips both (journaled), a budget of
    1 aborts on the second with ``BadRecordBudgetError``."""
    jl, pl = _pair(shuffle=False, max_bad_records=budget)
    jl.journal = JJournal(str(tmp_path / "jax.jsonl"))
    pl.journal = EventJournal(str(tmp_path / "port.jsonl"))
    jfi.install("data.collate", jfi.BadRecord(n=None, steps=[1, 3]))
    pfi.install("data.collate", pfi.BadRecord(n=None, steps=[1, 3]))
    outs = []
    for loader, exc in ((jl, jres.BadRecordBudgetError),
                        (pl, pres.BadRecordBudgetError)):
        got = []
        try:
            for _ in range(4):
                got.append(next(loader)["tokens"][0, 0])
        except exc:
            got.append("abort")
        outs.append((got, loader.state_dict()))
    assert outs[1] == outs[0]
    got, want = _events(pl.journal.path), _events(jl.journal.path)
    assert got == want
    kinds = [e["kind"] for e in got]
    assert kinds == (["data.bad_record"] * 2 if budget == 2 else
                     ["data.bad_record"] * 2 + ["data.bad_record.abort"])


def test_per_epoch_loader_matches_jax():
    ds = _dataset(30)
    for kw in ({}, {"shuffle": True, "seed": 2}, {"drop_last": False}):
        jl = JDeepSpeedDataLoader(ds, 8, **kw)
        pl = DeepSpeedDataLoader(ds, 8, **kw)
        for epoch in range(2):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            got, want = list(pl), list(jl)
            assert len(got) == len(want) == len(jl)
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)


def _engine(tmp_path, data, **kw):
    spec = from_gpt(convert.config_from_jax(TINY_GPT, dtype=torch.float32))
    return deepspeed_tpu_torch.initialize(
        model=spec, device="cpu", generator=torch.Generator().manual_seed(0),
        config={"train_micro_batch_size_per_gpu": 8, "data": data},
        training_data=_dataset(), **kw)


def test_initialize_builds_the_loader_like_jax(tmp_path):
    engine, _, loader, _ = _engine(tmp_path, {"resumable": True,
                                              "shuffle": True, "seed": 7})
    assert isinstance(loader, pres.ResumableDataLoader)
    assert engine.training_dataloader is loader
    assert engine.data_iterator is loader
    want = jres.ResumableDataLoader(_dataset(), 8, shuffle=True, seed=7)
    _assert_batches_equal(next(loader), next(want))
    engine, _, plain, _ = _engine(tmp_path, {}, collate_fn=lambda items: {
        "tokens": np.stack([it["tokens"] for it in items])[:, :5]})
    assert isinstance(plain, DeepSpeedDataLoader)
    assert engine.data_iterator is None
    assert next(iter(plain))["tokens"].shape == (8, 5)
    engine, _, loader, _ = _engine(tmp_path, {"resumable": True,
                                              "checkpoint_iterator": False})
    assert engine.data_iterator is None


def test_checkpoint_carries_the_loader_position(tmp_path):
    """Three steps, a save, a fresh engine loads: its loader lands on the
    exact next batch, and ``client_state`` holds the JAX schema."""
    engine, _, loader, _ = _engine(tmp_path, {"resumable": True,
                                              "shuffle": True, "seed": 1})
    for _ in range(3):
        engine.train_batch_fused(next(loader))
    engine.save_checkpoint(str(tmp_path))
    with open(os.path.join(str(tmp_path), "global_step3",
                           "client_state.json")) as f:
        saved = json.load(f)["data_iterator"]
    assert saved == loader.state_dict()
    assert set(saved) == set(jres.ResumableDataLoader(
        _dataset(), 8).state_dict())
    fresh, _, fresh_loader, _ = _engine(tmp_path, {"resumable": True,
                                                   "shuffle": True,
                                                   "seed": 1})
    _, client = fresh.load_checkpoint(str(tmp_path))
    assert fresh_loader.step == 3 == client["data_iterator"]["batch_index"]
    _assert_batches_equal(next(fresh_loader), next(loader))
