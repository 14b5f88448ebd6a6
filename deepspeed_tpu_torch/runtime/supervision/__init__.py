"""Run supervision of the port: detect → decide → recover for long
preemptible runs (the JAX package's ``runtime/supervision/``).

- ``events``: append-only JSONL event journal (rollbacks, hangs,
  preemptions, heartbeat gaps, checkpoint commits) — the run's black box
- ``watchdog``: daemon-thread deadline timer armed around train steps; on
  expiry it dumps every thread's stack, emits a structured event, and
  aborts so the launcher restarts
- ``heartbeat``: per-process heartbeat files + a rank-0 monitor so dead
  hosts are *reported* instead of discovered by hanging in a barrier
- ``supervisor``: the RunSupervisor rollback-and-retry policy (divergence →
  reload newest verified tag → shrink LR / reset loss scale → quarantine
  the poisoned window → retry, bounded by ``max_rollbacks``)
- ``config``: the validated ``"supervision"`` config section
"""

from .config import (DeepSpeedSupervisionConfig, HeartbeatConfig,  # noqa: F401
                     RollbackConfig, SUPERVISION)
from .events import EventJournal, EventKind, read_events  # noqa: F401
from .heartbeat import HeartbeatMonitor, HeartbeatWriter  # noqa: F401
from .supervisor import RunSupervisor  # noqa: F401
from .watchdog import (StepWatchdog, comm_guard, dump_all_stacks,  # noqa: F401
                       get_global_watchdog, set_global_watchdog)
