"""Multi-host checkpoint commit protocol + resume consensus.

The port of the JAX package's ``runtime/checkpoint_engine/commit.py``.
The port trains one process, so its engine runs the protocol at world
size 1 (the barrier is trivially satisfied and every tag still carries
``rank0.ready`` and ``commit.json``); ``FileConsensusChannel`` runs any
number of simulated hosts, and ``CollectiveConsensusChannel`` refuses a
world of more than one process until the port has a comm layer
(ROADMAP.md Queue 1 #7).

The durability stack below this module is single-writer: each process
persists its bytes atomically and the coordinator's ``latest`` marker
advertises a tag only after *its own* writes landed.  On a multi-host pod
that is not enough — every rank writes per-rank shard files
(``offload_optimizer_rank<N>.npz``, ``dcn_ef_rank<N>.npz``) into the same
tag, and a SIGTERM mid-save can publish a tag missing another host's
shards, while at resume two hosts can silently pick *different* tags
(split-brain), defeating the bitwise-replay guarantees of the data
pipeline.  This module closes both holes with a two-phase commit and a
resume consensus:

Phase 1 (all ranks)
    After a rank's shard files land, it atomically publishes
    ``<dir>/<tag>/rank<N>.ready`` — a per-rank manifest (file list, byte
    sizes, SHA-256) that doubles as the commit vote.

Phase 2 (coordinator, rank 0)
    The coordinator waits on the commit barrier (filesystem poll with
    deadline + exponential backoff, consulting the heartbeat monitor so
    ranks already known dead fail the barrier immediately), re-verifies
    every rank manifest, then atomically publishes ``<dir>/<tag>/commit.json``
    — and only *then* may the ``latest`` marker move.  Barrier expiry
    degrades gracefully: the timeout is journaled (``ckpt.commit_timeout``
    with per-rank attribution), the tag is abandoned, and training keeps
    running on the previous verified tag — the step loop never wedges.

Resume consensus
    At load every host proposes its newest locally-verified *committed*
    tag and the group agrees on the minimum proposal over a timed
    host-plane channel (a collective over the comm layer, a polled
    consensus directory otherwise), journaled as
    ``ckpt.resume_consensus`` — elastic restarts, rollbacks, and
    fallback-chain loads land every host on one tag or abort loudly
    (``ckpt.consensus_failure``).

Torn-tag quarantine
    A tag with ready votes but no ``commit.json`` is *torn* (a writer died
    mid-save or the barrier expired).  Startup and ``keep_last`` retention
    detect torn tags, journal ``ckpt.torn_tag``, and sweep them so the
    fallback chain never trips over a half-written tag.

On-disk layout (state machine: WRITING → READY(rank) → COMMITTED → LATEST):

.. code-block:: text

    <dir>/<tag>/*_rank<N>.npz     # per-rank shards (atomic tmp+replace)
    <dir>/<tag>/rank<N>.ready     # phase-1 vote: per-rank manifest
    <dir>/<tag>/manifest.json     # global integrity manifest (coordinator)
    <dir>/<tag>/commit.json       # phase-2 marker: the tag is whole
    <dir>/latest                  # moves only after commit.json exists

Chaos coverage drives the named fault points ``ckpt.rank_write``,
``ckpt.commit_barrier``, and ``ckpt.publish_commit``
(``utils/fault_injection.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ...utils import fault_injection
from ...utils.logging import logger
from ..supervision.events import EventKind
from .config import CheckpointCommitConfig, CheckpointRetryConfig
from .integrity import _sha256, has_manifest, list_tags, read_manifest, verify_tag
from .storage import atomic_write_text

COMMIT = "commit.json"
COMMIT_VERSION = 1
READY_SUFFIX = ".ready"

_READY_RE = re.compile(r"^rank(\d+)\.ready$")
_RANK_FILE_RE = re.compile(r"(?:^|[._-])rank(\d+)[._-]")
_TRAILING_INT = re.compile(r"(\d+)\s*$")


class CheckpointCommitError(RuntimeError):
    """The commit could not be published (missing/corrupt rank manifests)."""


class ResumeConsensusError(RuntimeError):
    """The group could not agree on one resume tag — resuming anyway would
    split-brain the run, so the load aborts loudly instead."""


# ------------------------------------------------------------------- paths
def ready_name(rank: int) -> str:
    return f"rank{int(rank)}{READY_SUFFIX}"


def ready_path(save_dir: str, tag: str, rank: int) -> str:
    return os.path.join(save_dir, tag, ready_name(rank))


def commit_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, tag, COMMIT)


# ----------------------------------------------------------------- context
@dataclasses.dataclass
class CommitContext:
    """Everything the save/load paths need to run the protocol.

    Built by the caller (journal + heartbeat monitor attached) or lazily
    by the engine from the process world.  ``world_size <= 1``
    still runs the protocol — the barrier is trivially satisfied and every
    single-host tag carries a commit marker, so the same invariants are
    exercised (and testable) without a pod.
    """

    world_size: int = 1
    rank: int = 0
    config: CheckpointCommitConfig = dataclasses.field(
        default_factory=CheckpointCommitConfig)
    journal: Any = None          # EventJournal, duck-typed (.emit)
    heartbeat: Any = None        # HeartbeatMonitor, duck-typed (.check)
    channel: Any = None          # consensus channel, duck-typed (.agree_min)
    tracer: Any = None           # telemetry Tracer, duck-typed (.span) —
    #                              the commit barrier lands as a
    #                              ``ckpt.commit`` span in the owner's trace

    @property
    def is_coordinator(self) -> bool:
        return int(self.rank) == 0

    def emit(self, kind: str, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.emit(kind, **fields)


# --------------------------------------------------------- phase 1: ready
def rank_owned_files(save_dir: str, tag: str, rank: int) -> List[str]:
    """The shard files rank ``rank`` owns in ``<save_dir>/<tag>``: every
    non-tmp file whose name carries an explicit ``rank<N>`` marker matching
    this rank.  Global files (model/optim/client state) are the
    coordinator's and are hashed by the *global* manifest instead."""
    ckpt_dir = os.path.join(save_dir, tag)
    out: List[str] = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return out
    for n in sorted(names):
        if n.endswith(".tmp") or n.endswith(READY_SUFFIX) or n == COMMIT:
            continue
        m = _RANK_FILE_RE.search(n)
        if m and int(m.group(1)) == int(rank):
            out.append(n)
    return out


def write_rank_manifest(save_dir: str, tag: str, rank: int, world_size: int,
                        files: Optional[List[str]] = None,
                        meta: Optional[Dict[str, Any]] = None,
                        retry: Optional[CheckpointRetryConfig] = None) -> str:
    """Phase 1: hash this rank's shard files and atomically publish
    ``rank<N>.ready``.  The ready file IS the vote — its existence asserts
    every listed byte landed before it."""
    ckpt_dir = os.path.join(save_dir, tag)
    os.makedirs(ckpt_dir, exist_ok=True)
    fault_injection.fire("ckpt.rank_write", path=ready_path(save_dir, tag, rank),
                         tag=tag, rank=rank)
    rels = files if files is not None else rank_owned_files(save_dir, tag, rank)
    hashed: Dict[str, Dict[str, Any]] = {}
    for rel in rels:
        p = os.path.join(ckpt_dir, rel)
        hashed[rel] = {"bytes": os.path.getsize(p), "sha256": _sha256(p)}
    doc: Dict[str, Any] = {"version": COMMIT_VERSION, "tag": tag,
                           "rank": int(rank), "world_size": int(world_size)}
    doc.update(meta or {})
    doc["files"] = hashed
    return atomic_write_text(ready_path(save_dir, tag, rank),
                             json.dumps(doc, indent=1, sort_keys=True), retry)


def read_rank_manifest(load_dir: str, tag: str,
                       rank: int) -> Optional[Dict[str, Any]]:
    try:
        with open(ready_path(load_dir, tag, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def ready_ranks(load_dir: str, tag: str) -> List[int]:
    """Ranks whose phase-1 vote is on disk, sorted."""
    try:
        names = os.listdir(os.path.join(load_dir, tag))
    except OSError:
        return []
    out = []
    for n in names:
        m = _READY_RE.match(n)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def verify_rank_manifest(load_dir: str, tag: str,
                         rank: int) -> Tuple[bool, List[str]]:
    """Re-hash rank ``rank``'s shard files against its ready manifest."""
    doc = read_rank_manifest(load_dir, tag, rank)
    if doc is None:
        return False, [f"{tag}/{ready_name(rank)}: missing or unreadable"]
    problems: List[str] = []
    for rel, info in sorted(doc.get("files", {}).items()):
        p = os.path.join(load_dir, tag, rel)
        if not os.path.exists(p):
            problems.append(f"{tag}/{rel}: missing (rank {rank} shard)")
            continue
        size = os.path.getsize(p)
        if info.get("bytes") is not None and size != info["bytes"]:
            problems.append(
                f"{tag}/{rel}: {size} bytes != rank manifest {info['bytes']}")
            continue
        digest = info.get("sha256")
        if digest and _sha256(p) != digest:
            problems.append(f"{tag}/{rel}: sha256 mismatch (rank {rank} shard)")
    return (not problems), problems


# ------------------------------------------------------ phase 2: barrier
def wait_for_ready(save_dir: str, tag: str, world_size: int,
                   config: Optional[CheckpointCommitConfig] = None,
                   heartbeat: Any = None,
                   journal: Any = None) -> Tuple[bool, List[int], List[int]]:
    """The commit barrier: poll for every rank's ready vote.

    Returns ``(ok, missing, dead)``.  The poll interval backs off
    exponentially up to ``barrier_backoff_max_s``; the deadline bounds the
    whole wait.  With a heartbeat monitor attached, ranks the monitor
    already classifies stale/missing fail the barrier IMMEDIATELY (no
    point burning the full deadline waiting on a host known dead) — the
    dead-rank list is journaled with the timeout either way.
    """
    cfg = config or CheckpointCommitConfig()
    deadline = time.monotonic() + cfg.barrier_deadline_s
    interval = cfg.barrier_poll_s
    expected = set(range(int(world_size)))
    while True:
        fault_injection.fire("ckpt.commit_barrier", tag=tag, path=tag)
        missing = sorted(expected - set(ready_ranks(save_dir, tag)))
        if not missing:
            return True, [], []
        dead: List[int] = []
        if heartbeat is not None:
            try:
                cls = heartbeat.check()
                quiet = {s["rank"] for s in cls.get("stale", ())} | \
                    set(cls.get("missing", ()))
                dead = sorted(set(missing) & quiet)
            except Exception as e:  # a broken monitor must not wedge the save
                logger.warning(
                    f"[ckpt-commit] heartbeat consult failed during commit "
                    f"barrier: {e!r}")
        now = time.monotonic()
        if dead or now >= deadline:
            reason = "heartbeat marked rank(s) dead" if dead else \
                "commit barrier deadline expired"
            logger.error(
                f"[ckpt-commit] tag {tag}: {reason} — missing ready votes "
                f"from ranks {missing}"
                + (f" (heartbeat-dead: {dead})" if dead else "")
                + "; abandoning the tag (latest marker NOT moved)")
            if journal is not None:
                journal.emit(EventKind.CKPT_COMMIT_TIMEOUT, tag=tag,
                             missing_ranks=missing, dead_ranks=dead,
                             world_size=int(world_size),
                             deadline_s=cfg.barrier_deadline_s, reason=reason)
            return False, missing, dead
        time.sleep(min(interval, max(0.0, deadline - now)))
        interval = min(interval * 2, cfg.barrier_backoff_max_s)


def publish_commit(save_dir: str, tag: str, world_size: int,
                   meta: Optional[Dict[str, Any]] = None,
                   retry: Optional[CheckpointRetryConfig] = None,
                   journal: Any = None) -> str:
    """Phase 2: verify every rank's manifest, then atomically publish
    ``commit.json``.  Raises :class:`CheckpointCommitError` when any rank's
    shards fail verification — a commit marker over torn shards would be a
    lie the resume path later trusts."""
    problems: List[str] = []
    for r in range(int(world_size)):
        ok, probs = verify_rank_manifest(save_dir, tag, r)
        if not ok:
            problems.extend(probs)
    if problems:
        raise CheckpointCommitError(
            f"tag {tag}: rank shard verification failed at commit: "
            + "; ".join(problems))
    fault_injection.fire("ckpt.publish_commit", tag=tag, path=tag)
    doc: Dict[str, Any] = {"version": COMMIT_VERSION, "tag": tag,
                           "world_size": int(world_size),
                           "ranks": list(range(int(world_size)))}
    doc.update(meta or {})
    mpath = os.path.join(save_dir, tag, "manifest.json")
    if os.path.exists(mpath):
        # the commit pins the exact manifest it certified — a later swap of
        # the manifest (tamper or torn rewrite) is detectable
        doc["manifest_sha256"] = _sha256(mpath)
    out = atomic_write_text(commit_path(save_dir, tag),
                            json.dumps(doc, indent=1, sort_keys=True), retry)
    if journal is not None:
        journal.emit(EventKind.CKPT_COMMITTED, tag=tag,
                     world_size=int(world_size))
    logger.info(f"[ckpt-commit] tag {tag} committed "
                f"(world_size={world_size})")
    return out


def read_commit(load_dir: str, tag: str) -> Optional[Dict[str, Any]]:
    try:
        with open(commit_path(load_dir, tag)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_committed(load_dir: str, tag: str) -> bool:
    return os.path.exists(commit_path(load_dir, tag))


def uses_commit_protocol(load_dir: str, tag: str) -> bool:
    """True when the tag carries any protocol artifact (vote or commit) —
    tags written before this subsystem have neither and stay loadable."""
    return is_committed(load_dir, tag) or bool(ready_ranks(load_dir, tag))


def is_torn(load_dir: str, tag: str) -> bool:
    """A torn tag: ready vote(s) on disk but no commit marker — a writer
    died mid-save or the commit barrier expired."""
    return bool(ready_ranks(load_dir, tag)) and not is_committed(load_dir, tag)


def commit_status(load_dir: str, tag: str,
                  world_size: Optional[int] = None) -> Dict[str, Any]:
    """One tag's place in the protocol state machine, for tooling.

    ``verdict`` is one of ``"committed"`` (marker present, every rank
    manifest verifies), ``"torn-committed"`` (marker present but rank
    shards missing/corrupt — the serious one), ``"torn"`` (votes without a
    marker — quarantine candidate), ``"pre-commit"`` (no protocol
    artifacts: a tag from before this subsystem).
    """
    ready = ready_ranks(load_dir, tag)
    doc = read_commit(load_dir, tag)
    committed = doc is not None or is_committed(load_dir, tag)
    if world_size is None:
        if doc is not None and isinstance(doc.get("world_size"), int):
            world_size = doc["world_size"]
        elif ready:
            world_size = max(ready) + 1
    problems: List[str] = []
    if committed:
        for r in range(int(world_size or 0)):
            ok, probs = verify_rank_manifest(load_dir, tag, r)
            if not ok:
                problems.extend(probs)
        verdict = "torn-committed" if problems else "committed"
    elif ready:
        verdict = "torn"
    else:
        verdict = "pre-commit"
    missing = sorted(set(range(int(world_size or 0))) - set(ready))
    return {"tag": tag, "verdict": verdict, "committed": committed,
            "world_size": world_size, "ready_ranks": ready,
            "missing_ranks": missing, "problems": problems}


# --------------------------------------------------------------- sweeping
def find_torn_tags(load_dir: str) -> List[str]:
    """Every torn tag under ``load_dir`` — including shard-only dirs a
    non-coordinator writer left behind (no global files, so ``list_tags``
    alone would miss them)."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    out = []
    for n in sorted(names):
        if os.path.isdir(os.path.join(load_dir, n)) and is_torn(load_dir, n):
            out.append(n)
    return out


def sweep_torn_tags(load_dir: str, journal: Any = None,
                    protect: Tuple[str, ...] = (),
                    min_age_s: float = 0.0) -> List[str]:
    """Quarantine: delete every torn tag, journaling ``ckpt.torn_tag`` per
    sweep.  Idempotent (a second sweep finds nothing) and safe to run
    concurrently from several hosts (``rmtree`` ignores races).  ``protect``
    spares named tags (the one being written right now); ``min_age_s``
    spares tags younger than the grace window so a retention-time sweep
    can't eat a sibling writer's in-flight tag."""
    removed: List[str] = []
    now = time.time()
    for tag in find_torn_tags(load_dir):
        if tag in protect:
            continue
        path = os.path.join(load_dir, tag)
        if min_age_s > 0:
            try:
                if now - os.path.getmtime(path) < min_age_s:
                    continue
            except OSError:
                continue
        ready = ready_ranks(load_dir, tag)
        shutil.rmtree(path, ignore_errors=True)
        if os.path.isdir(path):
            logger.warning(
                f"[ckpt-commit] could not fully sweep torn tag {tag} "
                f"under {load_dir} (concurrent sweep or busy files)")
            continue
        removed.append(tag)
        logger.warning(
            f"[ckpt-commit] swept torn tag {tag} under {load_dir} "
            f"(ready votes from ranks {ready}, no {COMMIT})")
        if journal is not None:
            journal.emit(EventKind.CKPT_TORN_TAG, tag=tag, ready_ranks=ready)
    return removed


# ------------------------------------------------------ resume consensus
def _tag_step(load_dir: str, tag: str) -> int:
    """The step a tag represents, for min-agreement: commit doc beats
    manifest beats the trailing integer in the tag name; -1 = unknown."""
    for doc in (read_commit(load_dir, tag), read_manifest(load_dir, tag)):
        if doc is not None and isinstance(doc.get("step"), int):
            return doc["step"]
    m = _TRAILING_INT.search(tag)
    return int(m.group(1)) if m else -1


def local_commit_proposal(load_dir: str) -> Tuple[int, Optional[str]]:
    """This host's vote: ``(step, tag)`` of the newest committed tag that
    verifies locally, or ``(-1, None)`` when nothing is resumable."""
    for tag in list_tags(load_dir, newest_first=True):
        if not is_committed(load_dir, tag):
            continue
        if has_manifest(load_dir, tag) and not verify_tag(load_dir, tag)[0]:
            continue
        step = _tag_step(load_dir, tag)
        if step >= 0:
            return step, tag
    return -1, None


class FileConsensusChannel:
    """Shared-filesystem consensus: each host atomically publishes its
    proposal under ``<dir>/<round>/rank<N>.json`` and polls for the rest,
    with the same deadline/backoff discipline as the commit barrier.  The
    channel for hosts that share a filesystem but no comm layer, and the
    one chaos tests drive with N simulated hosts.

    Round isolation: every ``agree_min`` call opens a fresh numbered round
    directory, so a later consensus (a rollback reload after the startup
    resume) can never read an earlier round's stale proposals.  Hosts must
    therefore call in lockstep — the same sequence of consensus events per
    process — which resume/rollback naturally satisfies (the whole group
    restarts or rolls back together).  Stale rounds from a *previous
    incarnation* are the coordinator's to sweep at startup
    (:meth:`sweep_rounds`); the poll loop re-asserts this host's own
    proposal if a concurrent sweep ate it, so the race degrades to a loud
    deadline abort at worst, never a silent split-brain.
    """

    def __init__(self, directory: str, rank: int, world_size: int,
                 round_id: str = "resume",
                 deadline_s: float = 60.0, poll_s: float = 0.02,
                 backoff_max_s: float = 0.5):
        self.directory = str(directory)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.round_id = str(round_id)
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s)
        self.backoff_max_s = float(backoff_max_s)
        self._round = 0

    def sweep_rounds(self) -> None:
        """Remove every round directory (coordinator, at startup, BEFORE
        the first consensus of this incarnation)."""
        shutil.rmtree(self.directory, ignore_errors=True)

    def agree_min(self, value: int) -> int:
        self._round += 1
        rdir = os.path.join(self.directory,
                            f"{self.round_id}-{self._round:04d}")
        os.makedirs(rdir, exist_ok=True)
        own = os.path.join(rdir, f"rank{self.rank}.json")
        payload = json.dumps({"rank": self.rank, "value": int(value)})
        atomic_write_text(own, payload)
        deadline = time.monotonic() + self.deadline_s
        interval = self.poll_s
        while True:
            if not os.path.exists(own):  # a concurrent sweep ate our vote
                os.makedirs(rdir, exist_ok=True)
                atomic_write_text(own, payload)
            proposals: Dict[int, int] = {}
            try:
                names = os.listdir(rdir)
            except OSError:
                names = []
            for n in names:
                m = re.match(r"^rank(\d+)\.json$", n)
                if not m:
                    continue
                try:
                    with open(os.path.join(rdir, n)) as f:
                        proposals[int(m.group(1))] = int(json.load(f)["value"])
                except (OSError, ValueError, KeyError, TypeError):
                    continue  # torn proposal: treated as not yet written
            if len(proposals) >= self.world_size:
                return min(proposals.values())
            if time.monotonic() >= deadline:
                missing = sorted(set(range(self.world_size)) - set(proposals))
                raise ResumeConsensusError(
                    f"resume consensus timed out after {self.deadline_s}s: "
                    f"no proposal from ranks {missing}")
            time.sleep(interval)
            interval = min(interval * 2, self.backoff_max_s)


class CollectiveConsensusChannel:
    """Host-plane collective consensus (min over proposals).  The JAX
    package runs it as a timed collective of its comm layer; the port has
    none yet, so a world of more than one process raises (ROADMAP.md
    Queue 1 #7) and a world of one agrees with itself."""

    def __init__(self, group=None, world_size: Optional[int] = None):
        self.group = group
        self.world_size = process_world_size() if world_size is None \
            else int(world_size)
        if self.world_size > 1:
            raise NotImplementedError(
                f"resume consensus over {self.world_size} processes needs "
                "the comm layer, which is not ported yet (ROADMAP.md Queue "
                "1 #7); use FileConsensusChannel over a shared directory")

    def agree_min(self, value: int) -> int:
        return int(value)


def process_world_size() -> int:
    """The ``torch.distributed`` world size when a process group is up,
    else 1."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def agree_resume_tag(load_dir: str, ctx: CommitContext) -> Optional[str]:
    """Run the resume consensus; returns the agreed tag (``None`` = every
    host is fresh, start from scratch).

    Raises :class:`ResumeConsensusError` when this host cannot honor the
    agreement — the agreed tag is missing/corrupt locally, or this host has
    a resumable tag while another host has nothing (resuming would fork
    the group's trajectories).
    """
    step, tag = local_commit_proposal(load_dir)
    if ctx.world_size <= 1 or ctx.channel is None:
        ctx.emit(EventKind.CKPT_RESUME_CONSENSUS, tag=tag, step=step,
                 local_tag=tag, local_step=step,
                 world_size=int(ctx.world_size))
        return tag
    agreed = int(ctx.channel.agree_min(step))
    if agreed == step:
        ctx.emit(EventKind.CKPT_RESUME_CONSENSUS, tag=tag, step=agreed,
                 local_tag=tag, local_step=step,
                 world_size=int(ctx.world_size))
        return tag
    if agreed < 0:
        # somebody has nothing: the group cannot resume consistently while
        # this host replays from `tag` — abort loudly rather than fork
        ctx.emit(EventKind.CKPT_CONSENSUS_FAILURE, local_tag=tag,
                 local_step=step, agreed_step=agreed,
                 reason="peer host proposed no resumable tag")
        raise ResumeConsensusError(
            f"resume consensus: a peer host has no committed tag while this "
            f"host proposes {tag!r} (step {step}) — refusing to fork the "
            f"group; clear {load_dir} everywhere or restore the peer")
    agreed_tag = None
    for cand in list_tags(load_dir, newest_first=True):
        if _tag_step(load_dir, cand) == agreed and \
                is_committed(load_dir, cand):
            agreed_tag = cand
            break
    if agreed_tag is None or (has_manifest(load_dir, agreed_tag)
                              and not verify_tag(load_dir, agreed_tag)[0]):
        ctx.emit(EventKind.CKPT_CONSENSUS_FAILURE, local_tag=tag,
                 local_step=step, agreed_step=agreed,
                 reason="agreed tag missing or corrupt locally")
        raise ResumeConsensusError(
            f"resume consensus agreed on step {agreed} but no verified "
            f"committed tag at that step exists under {load_dir} on this "
            f"host — aborting instead of silently diverging from the group")
    logger.warning(
        f"[ckpt-commit] resume consensus: local newest committed tag "
        f"{tag!r} (step {step}) overruled — group agreed on "
        f"{agreed_tag!r} (step {agreed})")
    ctx.emit(EventKind.CKPT_RESUME_CONSENSUS, tag=agreed_tag, step=agreed,
             local_tag=tag, local_step=step, world_size=int(ctx.world_size))
    return agreed_tag
