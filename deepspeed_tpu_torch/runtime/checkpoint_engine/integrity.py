"""Per-tag integrity manifests, verified tag discovery, and retention.

The port of the JAX package's ``runtime/checkpoint_engine/integrity.py``;
a manifest written by either package verifies in the other.  At publish
time (after every byte of a tag has landed, before the ``latest``
marker advertises it) the writer drops ``<dir>/<tag>/manifest.json``:

.. code-block:: json

    {"version": 1,
     "tag": "global_step100",
     "step": 100,
     "world_size": 8,
     "files": {"model_states.npz": {"bytes": 8192, "sha256": "ab12…"},
               "optim_states.npz":  {"bytes": 16384, "sha256": "cd34…"},
               "client_state.json": {"bytes": 210,  "sha256": "ef56…"}}}

``verify_tag`` re-hashes every listed file; resume walks candidates
newest→oldest (``fallback_candidates``) and takes the first tag that both
verifies and deserializes.  ``prune_checkpoints`` implements ``keep_last``
retention without ever deleting the newest *verified* tag.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ...utils.logging import logger
from .config import CheckpointRetryConfig
from .storage import atomic_write_text

MANIFEST = "manifest.json"
MANIFEST_VERSION = 1


class CheckpointCorruptionError(RuntimeError):
    """An explicitly requested tag failed integrity verification."""

#: files that live in a checkpoint *root* (not inside tag dirs)
_NON_TAG_FILES = ("latest", "zero_to_fp32.py")

_TRAILING_INT = re.compile(r"(\d+)\s*$")


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(chunk), b""):
            h.update(blk)
    return h.hexdigest()


def _is_tag_dir(load_dir: str, name: str) -> bool:
    d = os.path.join(load_dir, name)
    if not os.path.isdir(d):
        return False
    if os.path.exists(os.path.join(d, "model_states.npz")) \
            or os.path.exists(os.path.join(d, MANIFEST)) \
            or os.path.exists(os.path.join(d, "commit.json")):
        return True
    # a shard-only dir a non-coordinator writer left behind (commit
    # protocol, rank<N>.ready votes) is still a tag — the fallback walk
    # must see it to reject it, and the torn-tag sweep to quarantine it
    try:
        return any(n.endswith(".ready") for n in os.listdir(d))
    except OSError:
        return False


def read_manifest(load_dir: str, tag: str) -> Optional[Dict[str, Any]]:
    """The parsed manifest of ``tag``, or None (absent/unreadable)."""
    path = os.path.join(load_dir, tag, MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_manifest(save_dir: str, tag: str,
                   meta: Optional[Dict[str, Any]] = None,
                   retry: CheckpointRetryConfig = None) -> str:
    """Hash every file currently in ``<save_dir>/<tag>`` and atomically
    write the manifest.  Call only after all of the tag's writes landed."""
    ckpt_dir = os.path.join(save_dir, tag)
    files: Dict[str, Dict[str, Any]] = {}
    for root, _, names in os.walk(ckpt_dir):
        for n in sorted(names):
            if n == MANIFEST or n.endswith(".tmp"):
                continue
            p = os.path.join(root, n)
            rel = os.path.relpath(p, ckpt_dir)
            files[rel] = {"bytes": os.path.getsize(p), "sha256": _sha256(p)}
    doc: Dict[str, Any] = {"version": MANIFEST_VERSION, "tag": tag}
    doc.update(meta or {})
    doc["files"] = files
    return atomic_write_text(os.path.join(ckpt_dir, MANIFEST),
                             json.dumps(doc, indent=1, sort_keys=True),
                             retry)


def verify_tag(load_dir: str, tag: str) -> Tuple[bool, List[str]]:
    """Re-hash ``tag`` against its manifest.

    Returns ``(ok, problems)``; every corruption found is listed (missing
    dir/manifest, unreadable manifest, missing file, size mismatch, digest
    mismatch), so callers can log the full rejection reason.
    """
    ckpt_dir = os.path.join(load_dir, tag)
    if not os.path.isdir(ckpt_dir):
        return False, [f"checkpoint dir {ckpt_dir} missing"]
    mpath = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(mpath):
        return False, [f"{tag}: no {MANIFEST}"]
    doc = read_manifest(load_dir, tag)
    if doc is None:
        return False, [f"{tag}: {MANIFEST} unreadable/corrupt"]
    files = doc.get("files")
    if not isinstance(files, dict) or not files:
        return False, [f"{tag}: {MANIFEST} lists no files"]
    problems: List[str] = []
    for rel, info in sorted(files.items()):
        p = os.path.join(ckpt_dir, rel)
        if not os.path.exists(p):
            problems.append(f"{tag}/{rel}: missing")
            continue
        size = os.path.getsize(p)
        want = info.get("bytes")
        if want is not None and size != want:
            problems.append(f"{tag}/{rel}: {size} bytes != manifest {want}")
            continue
        digest = info.get("sha256")
        if digest and _sha256(p) != digest:
            problems.append(f"{tag}/{rel}: sha256 mismatch")
    return (not problems), problems


def has_manifest(load_dir: str, tag: str) -> bool:
    return os.path.exists(os.path.join(load_dir, tag, MANIFEST))


def _tag_order_key(load_dir: str, tag: str) -> Tuple[int, float]:
    """Newest-first sort key: manifest step beats a trailing integer in the
    tag name beats directory mtime."""
    doc = read_manifest(load_dir, tag)
    step = None
    if doc is not None and isinstance(doc.get("step"), int):
        step = doc["step"]
    if step is None:
        m = _TRAILING_INT.search(tag)
        if m:
            step = int(m.group(1))
    try:
        mtime = os.path.getmtime(os.path.join(load_dir, tag))
    except OSError:
        mtime = 0.0
    return (step if step is not None else -1, mtime)


def list_tags(load_dir: str, newest_first: bool = True) -> List[str]:
    """Every tag dir under ``load_dir``, ordered by step/mtime."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    tags = [n for n in names
            if n not in _NON_TAG_FILES and _is_tag_dir(load_dir, n)]
    tags.sort(key=lambda t: _tag_order_key(load_dir, t),
              reverse=newest_first)
    return tags


def fallback_candidates(load_dir: str,
                        preferred: Optional[str] = None) -> List[str]:
    """Resume candidates, best-first: the ``latest``-marker tag (if any),
    then every other tag newest→oldest."""
    tags = list_tags(load_dir, newest_first=True)
    if preferred is not None and preferred in tags:
        tags.remove(preferred)
        tags.insert(0, preferred)
    elif preferred is not None:
        # stale latest marker: points at a tag that does not exist —
        # candidates are whatever tags DO exist
        logger.warning(
            f"[ckpt-integrity] latest marker names {preferred!r} but no such "
            f"tag exists under {load_dir} (stale marker)")
    return tags


def newest_verified_tag(load_dir: str) -> Optional[str]:
    for tag in list_tags(load_dir, newest_first=True):
        if verify_tag(load_dir, tag)[0]:
            return tag
    return None


def prune_checkpoints(save_dir: str, keep_last: Optional[int],
                      protect: Tuple[str, ...] = ()) -> List[str]:
    """Delete tags beyond the ``keep_last`` newest.  The newest *verified*
    tag and anything in ``protect`` are never deleted — retention must not
    destroy the only resumable checkpoint.  Returns the deleted tags."""
    if not keep_last or keep_last <= 0:
        return []
    tags = list_tags(save_dir, newest_first=True)
    if len(tags) <= keep_last:
        return []
    keep = set(tags[:keep_last]) | set(protect)
    nv = newest_verified_tag(save_dir)
    if nv is not None:
        keep.add(nv)
    removed = []
    for tag in tags[keep_last:]:
        if tag in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        removed.append(tag)
    if removed:
        logger.info(f"[ckpt-retention] pruned {len(removed)} old tag(s) "
                    f"under {save_dir}: {removed} (keep_last={keep_last})")
    return removed
