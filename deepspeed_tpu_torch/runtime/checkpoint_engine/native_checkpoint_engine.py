"""Synchronous numpy checkpoint engine + engine-state save/load helpers.

The port of the JAX package's ``runtime/checkpoint_engine/
native_checkpoint_engine.py``, writing its layout byte for byte in kind:

    <dir>/<tag>/model_states.npz        # params + loss-scale state
    <dir>/<tag>/optim_states.npz        # optimizer state, grad_acc (+ master)
    <dir>/<tag>/client_state.json
    <dir>/<tag>/manifest.json           # sizes + sha256 of every tag file
    <dir>/latest                        # text file naming the newest tag

Arrays are stored under their ``/``-joined tree paths.  npz has no
bfloat16 (or fp8): the host snapshot widens those to fp32, and a load
casts every array back to its template's dtype on the template's device
(bf16 → fp32 → bf16 is exact).  fp16 and fp32 are stored as they are.

Where the JAX package's state is immutable, the port's lives in flat
buffers that the next step updates in place: :func:`snapshot_host`
therefore copies every tensor into host memory that it owns before it
returns (an asynchronous writer must not write a later step's state), and
:func:`load_engine_checkpoint` first reads and checks a whole tag on the
host and only then copies it into the template's tensors, in place.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...utils import fault_injection
from ...utils.logging import logger
from .checkpoint_engine import CheckpointEngine
from .config import DeepSpeedCheckpointConfig
from .integrity import (MANIFEST, CheckpointCorruptionError,
                        fallback_candidates, has_manifest, prune_checkpoints,
                        verify_tag, write_manifest)
from .storage import atomic_write_npz, atomic_write_text

PyTree = Any

SEP = "/"


def _ckpt_config(config_params) -> DeepSpeedCheckpointConfig:
    if isinstance(config_params, DeepSpeedCheckpointConfig):
        return config_params
    return DeepSpeedCheckpointConfig.from_dict(config_params or {})


def resolve_tag(load_dir: str, tag: Optional[str]) -> Optional[str]:
    """The tag a load should target: the explicit ``tag`` when given, else
    the contents of ``<load_dir>/latest``, else None (nothing advertised)."""
    if tag is not None:
        return tag
    try:
        with open(os.path.join(load_dir, "latest")) as f:
            t = f.read().strip()
        return t or None
    except OSError:
        return None


def flatten_tree(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_into(template: PyTree, flat: Dict[str, np.ndarray], prefix: str = "",
                   missing: Optional[list] = None) -> PyTree:
    """Rebuild arrays following ``template``'s structure from flat storage.

    With a ``missing`` list supplied, a key absent from storage keeps the
    template's (live, initialized) value and is recorded instead of raising
    — forward-compatible resume when an optimizer gains a new state field
    between checkpoint and load.  Callers decide how much missing-ness is
    tolerable (a couple of new fields: fine; half the tree: corrupt file).
    """
    if isinstance(template, dict):
        return {k: unflatten_into(template[k], flat, f"{prefix}{k}{SEP}", missing)
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_into(v, flat, f"{prefix}{i}{SEP}", missing)
                              for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in flat:
        if missing is not None:
            missing.append(key)
            return template
        raise KeyError(f"checkpoint missing tensor {key!r}")
    return flat[key]


#: dtypes npz cannot hold: widened to fp32 on save
_WIDENED = tuple(getattr(torch, n) for n in
                 ("bfloat16", "float8_e4m3fn", "float8_e5m2")
                 if hasattr(torch, n))


def _host_copy(v) -> np.ndarray:
    """``v`` as a numpy array that owns its bytes: never a view of a
    live buffer, on the CPU either."""
    if not torch.is_tensor(v):
        return np.array(v, copy=True)
    t = v.detach().to("cpu", copy=True)
    if t.dtype in _WIDENED:
        t = t.to(torch.float32)
    return t.numpy()


def snapshot_host(state_dict: PyTree) -> Dict[str, np.ndarray]:
    """Flatten + copy to host numpy with npz-portable dtype widening
    (bf16/fp8 → fp32; the load template's dtype restores the narrow
    type).  Every array is a copy: the caller may step at once."""
    return {k: _host_copy(v) for k, v in flatten_tree(state_dict).items()}


class NativeCheckpointEngine(CheckpointEngine):
    def __init__(self, config_params=None):
        super().__init__(config_params)
        self.ckpt_config = _ckpt_config(config_params)

    def save(self, state_dict: PyTree, path: str) -> None:
        arrays = snapshot_host(state_dict)
        # tmp + os.replace (like the async engine): a crash mid-write never
        # leaves a half-file at the final path; transient I/O errors retry
        # under the configured backoff policy
        atomic_write_npz(path, arrays, self.ckpt_config.retry)

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def save_engine_checkpoint(save_dir: str, tag: str, state: Dict[str, Any],
                           client_state: Dict[str, Any], separate_master: bool,
                           save_latest: bool = True,
                           engine: Optional[CheckpointEngine] = None,
                           config: Optional[DeepSpeedCheckpointConfig] = None,
                           manifest_meta: Optional[Dict[str, Any]] = None,
                           commit_ctx=None) -> None:
    """Persist an engine state tree as ``<save_dir>/<tag>``.

    With a :class:`~.commit.CommitContext` the multi-host two-phase commit
    runs: every rank votes ``rank<N>.ready`` after its shards land, and a
    non-coordinator rank returns right after voting (the global files and
    publication are the coordinator's).  The coordinator waits the commit
    barrier, verifies every vote, publishes ``commit.json``, and only then
    moves the ``latest`` marker; barrier expiry abandons the tag gracefully
    (journaled ``ckpt.commit_timeout``) instead of wedging the step loop.
    Without a context the single-writer path is unchanged (back-compat).
    """
    if config is None:
        config = getattr(engine, "ckpt_config", None) or \
            DeepSpeedCheckpointConfig()
    cctx = commit_ctx
    if cctx is not None and not cctx.config.enabled:
        cctx = None
    eng = engine or NativeCheckpointEngine(config)
    ckpt_dir = os.path.join(save_dir, tag)
    os.makedirs(ckpt_dir, exist_ok=True)
    if cctx is not None and not cctx.is_coordinator:
        # phase 1 only: this rank's shard files were written (atomically)
        # by the engine before this call — hash them and vote ready.  The
        # coordinator owns the global files, the barrier, and publication.
        from .commit import write_rank_manifest
        write_rank_manifest(save_dir, tag, cctx.rank, cctx.world_size,
                            retry=config.retry)
        return
    model_state = {"params": state["params"], "scale": state["scale"]}
    # grad_acc is saved so a checkpoint taken mid-accumulation-window resumes
    # with its partial gradients instead of silently dropping them
    optim_state = {"opt_state": state["opt_state"], "grad_acc": state["grad_acc"]}
    if separate_master:
        optim_state["master"] = state["master"]
    eng.save(model_state, os.path.join(ckpt_dir, "model_states.npz"))
    eng.save(optim_state, os.path.join(ckpt_dir, "optim_states.npz"))
    atomic_write_text(os.path.join(ckpt_dir, "client_state.json"),
                      json.dumps(client_state, default=str), config.retry)

    def publish():
        # the commit protocol (barrier → manifest → marker → retention) is
        # one ckpt.commit span in the owner's trace when a tracer rides
        # the context
        tracer = getattr(cctx, "tracer", None) if cctx is not None else None
        if tracer is not None:
            from ...telemetry.spans import SpanName
            with tracer.span(SpanName.CKPT_COMMIT, tag=tag):
                return _publish()
        return _publish()

    def _publish():
        # commit barrier first (every rank's shards must be voted whole),
        # then the manifest (it hashes every file of the tag, ready votes
        # included), then the commit marker, then the latest marker, then
        # retention — the marker never advertises an uncommitted tag and
        # retention never runs before the new tag is fully durable
        step = client_state.get("global_steps")
        if cctx is not None:
            from .commit import (CheckpointCommitError, publish_commit,
                                 sweep_torn_tags, wait_for_ready,
                                 write_rank_manifest)
            write_rank_manifest(save_dir, tag, cctx.rank, cctx.world_size,
                                retry=config.retry)
            ok, _missing, _dead = wait_for_ready(
                save_dir, tag, cctx.world_size, config=cctx.config,
                heartbeat=cctx.heartbeat, journal=cctx.journal)
            if not ok:
                # graceful degradation: the tag is abandoned (it will be
                # swept as torn at the next startup/retention pass), the
                # latest marker stays on the previous committed tag, and
                # training continues
                return False
        if config.integrity:
            meta = {"step": step}
            meta.update(manifest_meta or {})
            write_manifest(save_dir, tag, meta, config.retry)
        if cctx is not None:
            try:
                publish_commit(save_dir, tag, cctx.world_size,
                               meta={"step": step}, retry=config.retry,
                               journal=cctx.journal)
            except CheckpointCommitError as e:
                logger.error(f"[ckpt-commit] tag {tag} NOT committed: {e}")
                return False
        if save_latest:
            fault_injection.fire("ckpt.publish", tag=tag)
            atomic_write_text(os.path.join(save_dir, "latest"), tag,
                              config.retry)
        logger.info(f"saved checkpoint {tag} to {ckpt_dir}")
        if config.keep_last:
            prune_checkpoints(save_dir, config.keep_last, protect=(tag,))
        if cctx is not None:
            sweep_torn_tags(save_dir, journal=cctx.journal, protect=(tag,),
                            min_age_s=cctx.config.sweep_min_age_s)
        return True

    # the latest marker publishes only after every write of the tag lands
    # (nebula semantics).  An async engine chains publication behind its
    # writers WITHOUT blocking the caller — that's the whole point of
    # async_save; sync engines commit inline.
    if hasattr(eng, "finalize_async"):
        eng.finalize_async(tag, publish)
    else:
        eng.commit(tag)
        publish()


def _check_like(template: PyTree, loaded: PyTree, prefix: str = "") -> None:
    """Raise unless every loaded array has its template's shape (a copy
    into the template would broadcast a wrong one silently)."""
    if isinstance(template, dict):
        for k in template:
            _check_like(template[k], loaded[k], f"{prefix}{k}{SEP}")
    elif isinstance(template, (list, tuple)):
        for i, (t, l) in enumerate(zip(template, loaded)):
            _check_like(t, l, f"{prefix}{i}{SEP}")
    elif loaded is not template and \
            tuple(np.shape(loaded)) != tuple(template.shape):
        raise ValueError(f"checkpoint tensor {prefix[:-1]!r} has shape "
                         f"{tuple(np.shape(loaded))}, the engine's "
                         f"{tuple(template.shape)}")


def _copy_into(template: PyTree, loaded: PyTree) -> None:
    """Copy ``loaded`` (host arrays) into ``template``'s tensors in place:
    each array moves to its template's device and is cast there to the
    template's dtype.  A leaf that is its template (kept, not loaded) is
    left alone."""
    if isinstance(template, dict):
        for k in template:
            _copy_into(template[k], loaded[k])
    elif isinstance(template, (list, tuple)):
        for t, l in zip(template, loaded):
            _copy_into(t, l)
    elif loaded is not template:
        src = torch.from_numpy(np.asarray(loaded))
        template.copy_(src.to(template.device))


def load_engine_checkpoint(load_dir: str, tag: Optional[str], state: Dict[str, Any],
                           load_optimizer_states: bool = True,
                           separate_master: bool = True,
                           config: Optional[DeepSpeedCheckpointConfig] = None
                           ) -> Tuple[Optional[Dict], Dict]:
    """Load the newest checkpoint that verifies AND deserializes into
    ``state``'s tensors, in place; returns ``(state, client_state)``, or
    ``(None, {})`` with ``state`` untouched when nothing loads.

    With an explicit ``tag`` the chain is that single tag (verification
    failure raises — a pinned tag silently swapped for another would be
    worse than a crash).  With ``tag=None`` the candidates are the
    ``latest``-marker tag followed by every other tag newest→oldest; each
    rejection (failed manifest verification, failed deserialization or
    shape check, missing dir) is loudly logged and the walk continues, so
    a truncated newest tag or a stale ``latest`` marker degrades to
    resuming from the newest surviving checkpoint instead of a hard
    failure or a silent non-resume.  A tag is read and checked whole on
    the host before any tensor of ``state`` is written.  The tag actually
    loaded is reported to callers as ``client_state["_ckpt_tag"]``.

    Without ``load_optimizer_states`` the optimizer state, ``grad_acc``
    and a separate ``master`` keep their values, as in the JAX package.
    """
    cfg = config if config is not None else DeepSpeedCheckpointConfig()
    eng = NativeCheckpointEngine(cfg)
    explicit = tag is not None
    requested = resolve_tag(load_dir, tag)

    if explicit:
        candidates = [requested]
    elif cfg.verify_on_load:
        candidates = fallback_candidates(load_dir, requested)
    else:
        candidates = [requested] if requested is not None else []
    if not candidates:
        logger.warning(f"no 'latest' file and no tag dirs under {load_dir}; "
                       "nothing loaded")
        return None, {}

    # a directory where NO candidate carries a manifest predates the
    # integrity subsystem: its tags load unverified (back-compat).  Once any
    # tag has a manifest, a manifest-less tag is an unpublished or tampered
    # one and is rejected by the fallback walk.
    any_manifest = any(has_manifest(load_dir, t) for t in candidates)

    from .commit import is_torn

    for cand in candidates:
        ckpt_dir = os.path.join(load_dir, cand)
        if not os.path.isdir(ckpt_dir):
            logger.warning(f"checkpoint dir {ckpt_dir} missing; "
                           + ("nothing loaded" if explicit else "skipping"))
            if explicit:
                return None, {}
            continue
        if is_torn(load_dir, cand):
            # ready votes without a commit marker: a writer died mid-save
            # or the commit barrier expired — the tag may be missing
            # another host's shards and must never be resumed from
            if explicit:
                raise CheckpointCorruptionError(
                    f"checkpoint tag {cand!r} under {load_dir} is torn "
                    f"(rank ready votes present but no commit marker)")
            logger.error(f"[ckpt-integrity] REJECTED tag {cand}: torn "
                         "(ready votes without commit.json — uncommitted "
                         "multi-host save)")
            continue
        if cfg.verify_on_load:
            if has_manifest(load_dir, cand):
                ok, problems = verify_tag(load_dir, cand)
                if not ok:
                    if explicit:
                        raise CheckpointCorruptionError(
                            f"checkpoint tag {cand!r} under {load_dir} failed "
                            f"integrity verification: {'; '.join(problems)}")
                    logger.error(f"[ckpt-integrity] REJECTED tag {cand}: "
                                 + "; ".join(problems))
                    continue
            elif any_manifest and not explicit:
                logger.error(
                    f"[ckpt-integrity] REJECTED tag {cand}: no {MANIFEST} "
                    "while sibling tags have one (unpublished or tampered)")
                continue
            else:
                logger.warning(f"tag {cand} has no {MANIFEST} "
                               "(pre-integrity checkpoint); loading unverified")
        try:
            loaded, client_state = _load_tag(
                eng, ckpt_dir, state, load_optimizer_states, separate_master)
        except Exception as e:
            if explicit:
                raise
            logger.error(f"[ckpt-integrity] REJECTED tag {cand}: "
                         f"failed to deserialize: {e!r}")
            continue
        if requested is not None and cand != requested:
            logger.warning(
                f"[ckpt-integrity] FELL BACK to tag {cand} — requested/"
                f"advertised tag {requested!r} was missing or corrupt")
        with torch.no_grad():
            for key, tree in loaded.items():
                _copy_into(state[key], tree)
        client_state = dict(client_state)
        client_state["_ckpt_tag"] = cand
        logger.info(f"loaded checkpoint {cand} from {ckpt_dir}")
        return state, client_state

    logger.error(f"[ckpt-integrity] no loadable checkpoint under {load_dir} "
                 f"(walked {candidates}); nothing loaded")
    return None, {}


def _load_tag(eng: CheckpointEngine, ckpt_dir: str, state: Dict[str, Any],
              load_optimizer_states: bool,
              separate_master: bool) -> Tuple[Dict, Dict]:
    """Read and check one tag on the host: ``({state key: tree of host
    arrays following the template}, client_state)``; nothing is copied."""
    model_flat = eng.load(os.path.join(ckpt_dir, "model_states.npz"))
    loaded = {
        "params": unflatten_into(state["params"], model_flat, "params" + SEP),
        "scale": unflatten_into(state["scale"], model_flat, "scale" + SEP)}

    if load_optimizer_states:
        optim_flat = eng.load(os.path.join(ckpt_dir, "optim_states.npz"))
        missing: list = []
        opt = unflatten_into(state["opt_state"], optim_flat, "opt_state" + SEP,
                             missing=missing)
        n_leaves = len(flatten_tree(state["opt_state"]))
        if missing:
            # schema evolution vs corruption: a missing leaf whose parent
            # subtree has NO stored tensors at all is a field that didn't
            # exist when the checkpoint was written — keeping its
            # initialized value is correct and shouldn't count toward the
            # corruption threshold.  Scattered missing leaves inside an
            # otherwise-present subtree do.
            def _benign(key: str) -> bool:
                parent = key.rsplit(SEP, 1)[0] + SEP if SEP in key else ""
                return parent != "" and not any(
                    s.startswith(parent) for s in optim_flat)

            suspicious = [k for k in missing if not _benign(k)]
            if len(suspicious) > max(2, n_leaves // 4):
                raise KeyError(
                    f"optim_states.npz is missing {len(suspicious)}/{n_leaves} "
                    f"tensors (e.g. {suspicious[:3]}) — corrupt or truncated "
                    f"checkpoint, refusing to resume from it")
            logger.warning(
                f"checkpoint missing {len(missing)} optimizer tensors "
                f"({missing[:5]}...); keeping initialized values (new "
                f"optimizer state fields?)")
        loaded["opt_state"] = opt
        if any(k.startswith("grad_acc" + SEP) for k in optim_flat):
            loaded["grad_acc"] = unflatten_into(state["grad_acc"], optim_flat,
                                                "grad_acc" + SEP)
        if separate_master:
            loaded["master"] = unflatten_into(state["master"], optim_flat,
                                              "master" + SEP)
    # without a separate master, master and params are one buffer: the
    # params just loaded are the master
    for key, tree in loaded.items():
        _check_like(state[key], tree, key + SEP)

    client_path = os.path.join(ckpt_dir, "client_state.json")
    client_state = {}
    if os.path.exists(client_path):
        with open(client_path) as f:
            client_state = json.load(f)
    return loaded, client_state
