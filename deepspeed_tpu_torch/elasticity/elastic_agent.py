"""Preemption-resume execution: the port of the JAX package's
``elasticity/elastic_agent.py`` (``ElasticTrainRunner``), the counterpart
of the reference's torchelastic ``DSElasticAgent``.

A preemptible card is taken away whole (maintenance, spot reclaim) and the
job is relaunched.  The runner is the train loop that

- resumes from the newest verified checkpoint at startup,
- checkpoints on SIGTERM/SIGINT (the preemption notice) at the next step
  boundary and waits for that tag's bytes to land before it returns; a
  SECOND signal during the drain escalates to immediate exit (the first
  signal restores the previous handlers, so a stuck step can't make the
  drain unkillable),
- checkpoints every ``save_interval`` steps as a bound on lost work,
- validates the world size against the elastic admission algebra,
- under a ``"supervision"`` config section, closes the detect→decide→
  recover loop: a step watchdog converts hangs into stack-dumped aborts, a
  heartbeat thread marks this host live, and the consecutive-NaN guard is
  upgraded from abort-always to bounded rollback-and-retry
  (``runtime/supervision/``).

It drives ``engine.train_batch_fused`` once per batch; the process world
is one rank (``checkpoint_engine.commit.process_world_size``).
"""

from __future__ import annotations

import math
import os
import signal
import time
from contextlib import nullcontext
from typing import Any, Dict, Iterable, Optional, Union

from ..runtime.checkpoint_engine.commit import (CollectiveConsensusChannel,
                                                CommitContext,
                                                process_world_size,
                                                sweep_torn_tags)
from ..runtime.supervision import (DeepSpeedSupervisionConfig, EventJournal,
                                   HeartbeatMonitor, HeartbeatWriter,
                                   RunSupervisor, StepWatchdog,
                                   set_global_watchdog)
from ..runtime.supervision.events import EventKind
from ..telemetry.metrics import MetricName
from ..telemetry.spans import SpanName
from ..utils import fault_injection
from ..utils.logging import log_dist, logger
from .elasticity import (compute_elastic_config, elasticity_enabled,
                         ensure_immutable_elastic_config)


class ElasticTrainRunner:
    """Drives engine.train_batch_fused with checkpoint-based elasticity.

    Args:
      engine: a live DeepSpeedEngine (already initialized).
      data_iter: iterator of batches (or pass batches to ``run``).
      save_dir: checkpoint directory shared across restarts.
      save_interval: steps between periodic checkpoints.
      ds_config: when it carries an enabled "elasticity" section, the
        current dp world size is validated against the admissible set; its
        "supervision" section (if any) configures the watchdog/heartbeat/
        rollback machinery.
      nan_abort_threshold: a divergence is declared after this many
        CONSECUTIVE non-finite losses.  Without supervision (or with
        ``rollback.max_rollbacks=0``) the run aborts (RuntimeError) and
        never checkpoints the poisoned state; with supervision it rolls
        back to the newest verified tag and retries, bounded by
        ``max_rollbacks``.  0 disables the guard; isolated non-finite
        losses (fp16 overflow skips) reset the streak.
      supervision: explicit supervision config (dict or typed), overriding
        ``ds_config["supervision"]``.
      rank: host identity for supervision journaling, heartbeat files, and
        the commit context (defaults to ``engine.global_rank``).
    """

    def __init__(self, engine, save_dir: str, save_interval: int = 100,
                 ds_config: Optional[Dict[str, Any]] = None,
                 tag_prefix: str = "elastic",
                 nan_abort_threshold: int = 5,
                 supervision: Optional[Union[Dict[str, Any],
                                             DeepSpeedSupervisionConfig]] = None,
                 rank: Optional[int] = None):
        self.engine = engine
        self.save_dir = save_dir
        self.save_interval = max(1, save_interval)
        self.tag_prefix = tag_prefix
        self.nan_abort_threshold = max(0, nan_abort_threshold)
        self.rank = int(rank) if rank is not None else \
            int(getattr(engine, "global_rank", 0))
        self._nan_streak = 0
        self._preempted = False
        self._preempt_at: Optional[float] = None
        self._prev_handlers = {}

        if ds_config is not None and elasticity_enabled(ds_config):
            # admission check, then latch the config hash so a restarted
            # worker with an edited elasticity section fails loudly instead
            # of silently training on a different schedule (reference
            # elasticity.py:254)
            compute_elastic_config(
                ds_config, world_size=engine.dp_world_size)
            ensure_immutable_elastic_config(ds_config["elasticity"])

        self._configure_supervision(supervision, ds_config)
        self._attach_commit_context(self.rank)
        self._configure_telemetry()

    # ---------------------------------------------------------- telemetry
    def _configure_telemetry(self) -> None:
        """Ride the engine's telemetry: runner-phase spans (data fetch,
        resume, rollback) land in the engine's tracer, and the runner's
        rollback counter streams through the engine's metrics sampler
        under the runner's rank."""
        self.tracer = getattr(self.engine, "tracer", None)
        sampler = getattr(self.engine, "metrics_sampler", None)
        if sampler is not None and sampler.enabled:
            sampler.rank = self.rank
            sampler.attach_source(self._metrics_source)

    def _metrics_source(self) -> Dict[str, Any]:
        if self.supervisor is None:
            return {}
        return {MetricName.ROLLBACKS: self.supervisor.total_rollbacks}

    def _span(self, name: str, **args):
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, **args)

    # -------------------------------------------------------- supervision
    def _configure_supervision(self, supervision, ds_config) -> None:
        cfg = supervision
        if cfg is None and isinstance(ds_config, dict):
            cfg = ds_config.get("supervision")
        if isinstance(cfg, dict):
            cfg = DeepSpeedSupervisionConfig.from_dict(cfg)
        self.supervision = cfg if (cfg is not None and cfg.enabled) else None
        self.journal: Optional[EventJournal] = None
        self.watchdog: Optional[StepWatchdog] = None
        self.supervisor: Optional[RunSupervisor] = None
        self.heartbeat: Optional[HeartbeatWriter] = None
        if self.supervision is None:
            return
        rank = self.rank
        jpath = self.supervision.event_journal or os.path.join(
            self.save_dir, "events.jsonl")
        self.journal = EventJournal(jpath, rank=rank)
        wd_deadline = self.supervision.step_deadline_s or \
            self.supervision.collective_deadline_s
        if wd_deadline:
            self.watchdog = StepWatchdog(wd_deadline, journal=self.journal)
        self.supervisor = RunSupervisor(self.engine, self.save_dir,
                                        self.supervision, journal=self.journal)
        hb = self.supervision.heartbeat_config
        if hb.enabled:
            hb_dir = hb.dir or os.path.join(self.save_dir, "heartbeats")
            self.heartbeat = HeartbeatWriter(hb_dir, rank,
                                             interval_s=hb.interval_s,
                                             journal=self.journal)

    def _attach_commit_context(self, rank: int) -> None:
        """Wire the multi-host commit protocol into the engine: the commit
        barrier gets this runner's journal and (on the coordinator) the
        heartbeat monitor, so ranks already classified dead fail the
        barrier immediately instead of burning the full deadline, and
        resume consensus is journaled next to every other run decision."""
        self.commit_ctx = None
        if not hasattr(self.engine, "set_commit_context"):
            return
        cfg = getattr(getattr(self.engine, "_config", None),
                      "checkpoint_config", None)
        commit_cfg = getattr(cfg, "commit_config", None)
        if commit_cfg is None or not commit_cfg.enabled:
            return
        world = process_world_size()
        monitor = None
        if rank == 0 and self.supervision is not None:
            hb = self.supervision.heartbeat_config
            if hb.enabled:
                hb_dir = hb.dir or os.path.join(self.save_dir, "heartbeats")
                monitor = HeartbeatMonitor(hb_dir, gap_s=hb.gap_s,
                                           journal=self.journal,
                                           expected_ranks=world,
                                           slow_factor=hb.slow_factor,
                                           slow_min_intervals=
                                           hb.slow_min_intervals)
        self.commit_ctx = CommitContext(
            world_size=world, rank=rank, config=commit_cfg,
            journal=self.journal, heartbeat=monitor,
            channel=CollectiveConsensusChannel(world_size=world)
            if world > 1 else None)
        self.engine.set_commit_context(self.commit_ctx)

    def _step_guard(self):
        if self.watchdog is not None and \
                self.supervision.step_deadline_s is not None:
            return self.watchdog.guard("train.step",
                                       self.supervision.step_deadline_s)
        return nullcontext()

    # -------------------------------------------------------------- signals
    def _on_signal(self, signum, frame):
        logger.warning(f"[elastic] received signal {signum}: will checkpoint "
                       "and exit at the next step boundary (a repeat signal "
                       "exits immediately)")
        self._preempted = True
        if self._preempt_at is None:
            # the preempt-save deadline clock starts at the FIRST notice —
            # a cloud preemptor's grace window is anchored there, not at
            # whenever the step boundary lets the drain begin
            self._preempt_at = time.monotonic()
        if self.journal is not None:
            self.journal.emit(EventKind.PREEMPT_SIGNAL, signum=int(signum),
                              step=self.engine.global_steps)
        # escalation: hand the signals back to the pre-install handlers NOW,
        # so a second SIGTERM/SIGINT during a stuck drain terminates the
        # process instead of being swallowed until a step boundary that may
        # never come
        self._restore()

    def _install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # non-main thread (tests): without handlers a preemption
                # notice can't drain gracefully — say so instead of hiding it
                logger.debug(
                    f"[elastic] cannot install handler for signal {sig} "
                    "from a non-main thread; preemption drain disabled")

    def _restore(self):
        for sig, h in self._prev_handlers.items():
            signal.signal(sig, h)
        self._prev_handlers.clear()

    # ------------------------------------------------------------------ run
    def resume(self) -> int:
        """Load the newest VERIFIED checkpoint if any; returns the step
        resumed at.  The engine's load walks the verified-fallback chain,
        so a corrupt newest tag or a stale ``latest`` marker resumes from
        the newest surviving tag; only an actual load is logged as a
        resume — otherwise warn and start fresh.  The coordinator first
        quarantines torn tags (shard files without a commit marker) so the
        fallback chain never trips over a half-written save from the
        previous incarnation."""
        with self._span(SpanName.ELASTIC_RESUME):
            return self._resume_inner()

    def _resume_inner(self) -> int:
        if not os.path.isdir(self.save_dir):
            return self.engine.global_steps
        ctx = getattr(self, "commit_ctx", None)
        if ctx is not None and ctx.is_coordinator and ctx.config.sweep_on_start:
            sweep_torn_tags(self.save_dir, journal=self.journal)
            if getattr(ctx.channel, "sweep_rounds", None) is not None:
                # stale consensus rounds from the previous incarnation
                # must not outvote this one
                ctx.channel.sweep_rounds()
        loaded, _ = self.engine.load_checkpoint(self.save_dir)
        if loaded is not None:
            log_dist(f"[elastic] resumed from step {self.engine.global_steps}",
                     ranks=[0])
        else:
            logger.warning(f"[elastic] no loadable checkpoint under "
                           f"{self.save_dir}; starting fresh from step "
                           f"{self.engine.global_steps}")
        return self.engine.global_steps

    def _save(self) -> str:
        tag = f"{self.tag_prefix}_step{self.engine.global_steps}"
        self.engine.save_checkpoint(self.save_dir, tag=tag)
        if self.supervisor is not None:
            # a published tag is forward progress: resets the consecutive
            # rollback budget once it passes the last divergence point
            self.supervisor.on_checkpoint(self.engine.global_steps)
        return tag

    def _drain_save(self) -> str:
        """The drain's save: a periodic save's tag, and then a wait until
        its bytes land (an async engine writes in the background, and the
        process may end as soon as the runner returns)."""
        tag = self._save()
        wait = getattr(self.engine, "wait_for_checkpoint", None)
        if wait is not None:
            wait()
        return tag

    def _preempt_save(self) -> None:
        """The drain checkpoint, bounded by ``preempt_save_deadline_s``
        when configured: attempt the commit only while the grace clock
        (started at the first signal) has time left, and journal how the
        race against the preemptor went — ``ckpt.preempt_save`` landed in
        time, ``ckpt.preempt_save_timeout`` did not (``saved`` says whether
        the tag made it to disk late or was skipped outright)."""
        deadline = self.supervision.preempt_save_deadline_s \
            if self.supervision is not None else None
        if deadline is None or self._preempt_at is None:
            self._drain_save()
            return
        step = self.engine.global_steps
        elapsed = time.monotonic() - self._preempt_at
        if elapsed >= deadline:
            logger.warning(
                f"[elastic] preempt-save deadline ({deadline}s) already "
                f"spent ({elapsed:.2f}s since the signal): skipping the "
                f"drain checkpoint — the preemptor wins this race")
            if self.journal is not None:
                self.journal.emit(EventKind.CKPT_PREEMPT_SAVE_TIMEOUT,
                                  step=step, elapsed_s=round(elapsed, 3),
                                  deadline_s=deadline, saved=False)
            return
        tag = self._drain_save()
        elapsed = time.monotonic() - self._preempt_at
        if elapsed <= deadline:
            if self.journal is not None:
                self.journal.emit(EventKind.CKPT_PREEMPT_SAVE, step=step,
                                  tag=tag, elapsed_s=round(elapsed, 3),
                                  deadline_s=deadline)
        else:
            logger.warning(
                f"[elastic] drain checkpoint {tag} landed {elapsed:.2f}s "
                f"after the signal — past the {deadline}s preempt-save "
                f"deadline (the tag is on disk, but the preemptor may have "
                f"already struck)")
            if self.journal is not None:
                self.journal.emit(EventKind.CKPT_PREEMPT_SAVE_TIMEOUT,
                                  step=step, elapsed_s=round(elapsed, 3),
                                  deadline_s=deadline, saved=True)

    def run(self, batches: Iterable[Any], max_steps: Optional[int] = None,
            resume: bool = True) -> Dict[str, Any]:
        """Train until batches run out, ``max_steps``, or preemption.

        Returns {"steps": n, "preempted": bool, "losses": [...],
        "rollbacks": n}.
        """
        # a stateful (resumable) batch source registers with the engine
        # BEFORE the resume load, so the checkpoint's iterator position is
        # restored into it and rollback quarantine windows land on it
        if hasattr(batches, "state_dict") and \
                hasattr(batches, "load_state_dict") and \
                hasattr(self.engine, "set_data_iterator"):
            self.engine.set_data_iterator(batches)
            if self.journal is not None and \
                    getattr(batches, "journal", None) is None:
                batches.journal = self.journal
        if resume:
            self.resume()
        start_step = self.engine.global_steps
        losses = []
        skip_remaining = 0
        self._install()
        if self.heartbeat is not None:
            self.heartbeat.start()
        if self.watchdog is not None and \
                self.supervision.collective_deadline_s is not None:
            set_global_watchdog(self.watchdog,
                                self.supervision.collective_deadline_s)
        batch_iter = iter(batches)
        try:
            while True:
                # decide BEFORE fetching: pulling a batch advances a
                # stateful loader, and a batch fetched past a preemption
                # or the step budget would be recorded as consumed in the
                # checkpointed iterator position without ever being trained
                if max_steps is not None and \
                        self.engine.global_steps - start_step >= max_steps:
                    break
                if self._preempted:
                    break
                if skip_remaining > 0:
                    # post-rollback relative skip (plain iterators only —
                    # resumable loaders enforce the absolute quarantine
                    # window themselves): consume without training
                    try:
                        next(batch_iter)
                    except StopIteration:
                        break
                    skip_remaining -= 1
                    continue
                try:
                    with self._span(SpanName.TRAIN_DATA_FETCH,
                                    step=self.engine.global_steps + 1):
                        batch = next(batch_iter)
                except StopIteration:
                    break
                with self._step_guard():
                    fault_injection.fire("train.step_begin",
                                         step=self.engine.global_steps + 1)
                    loss = float(self.engine.train_batch_fused(batch))
                # the loss rides in a mutable box so chaos plans can poison
                # a batch window (NaNLossWindow) and drive the divergence
                # machinery end-to-end from outside the process
                box = {"loss": loss}
                fault_injection.fire("train.loss",
                                     step=self.engine.global_steps, box=box)
                loss = float(box["loss"])
                losses.append(loss)
                if self.heartbeat is not None:
                    self.heartbeat.note_step(self.engine.global_steps)
                # consecutive-NaN divergence handling BEFORE any
                # checkpointing: never publish a tag whose trajectory has
                # already diverged
                if not math.isfinite(loss):
                    self._nan_streak += 1
                    if self.nan_abort_threshold and \
                            self._nan_streak >= self.nan_abort_threshold:
                        directive = None
                        if self.supervisor is not None:
                            with self._span(SpanName.ELASTIC_ROLLBACK,
                                            step=self.engine.global_steps):
                                directive = self.supervisor.on_divergence(
                                    self.engine.global_steps, loss)
                        if directive is None:
                            raise RuntimeError(
                                f"[elastic] loss was non-finite for "
                                f"{self._nan_streak} consecutive steps "
                                f"(last={loss}) — aborting without "
                                f"checkpointing the poisoned state")
                        # engine state already rolled back to the newest
                        # verified tag; restart the streak.  With a
                        # resumable loader the supervisor installed an
                        # absolute quarantine window (skip_batches is 0);
                        # plain iterators fall back to the relative skip
                        self._nan_streak = 0
                        skip_remaining = int(directive.get("skip_batches", 0))
                        continue
                    logger.warning(
                        f"[elastic] non-finite loss at step "
                        f"{self.engine.global_steps} "
                        f"({self._nan_streak}/{self.nan_abort_threshold or '∞'} "
                        f"consecutive before abort)")
                else:
                    self._nan_streak = 0
                fault_injection.fire("train.step",
                                     step=self.engine.global_steps)
                # a step inside a non-finite streak is never published —
                # resume-from-poisoned-state is worse than losing the window
                if self._nan_streak == 0 and \
                        self.engine.global_steps % self.save_interval == 0:
                    self._save()
            if self._preempted:
                if self._nan_streak == 0:
                    self._preempt_save()
                else:
                    logger.warning(
                        "[elastic] preempted mid NaN-streak: NOT writing a "
                        "preemption checkpoint (state may be poisoned)")
        finally:
            self._restore()
            if self.watchdog is not None:
                set_global_watchdog(None)
                self.watchdog.stop()
            if self.heartbeat is not None:
                self.heartbeat.stop()
        return {"steps": self.engine.global_steps - start_step,
                "preempted": self._preempted,
                "losses": losses,
                "rollbacks": (self.supervisor.total_rollbacks
                              if self.supervisor is not None else 0)}
