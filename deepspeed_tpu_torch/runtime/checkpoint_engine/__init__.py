"""Checkpoint backends + the durability subsystem.

The port of the JAX package's ``runtime/checkpoint_engine/``, writing its
on-disk layout: a tag saved by either package loads in the other.

- ``checkpoint_engine``: the pluggable backend ABC
- ``native_checkpoint_engine``: sync numpy engine + engine-state save/load
  (with the verified-fallback resume chain)
- ``async_checkpoint_engine``: background writers + deferred atomic publish
- ``integrity``: per-tag manifests, verification, retention
- ``commit``: multi-host two-phase commit, resume consensus, torn-tag
  quarantine
- ``storage``: retrying atomic writers (the only place bytes hit disk)
- ``config``: the validated ``"checkpoint"`` config section
"""

from .checkpoint_engine import CheckpointEngine  # noqa: F401
from .commit import (CheckpointCommitError, CommitContext,  # noqa: F401
                     FileConsensusChannel, ResumeConsensusError,
                     agree_resume_tag, commit_status, is_committed, is_torn,
                     publish_commit, read_commit, sweep_torn_tags,
                     wait_for_ready, write_rank_manifest)
from .config import (CheckpointCommitConfig, CheckpointRetryConfig,  # noqa: F401
                     DeepSpeedCheckpointConfig)
from .integrity import (CheckpointCorruptionError, list_tags,  # noqa: F401
                        newest_verified_tag, prune_checkpoints, verify_tag,
                        write_manifest)
from .native_checkpoint_engine import (NativeCheckpointEngine,  # noqa: F401
                                       load_engine_checkpoint, resolve_tag,
                                       save_engine_checkpoint)
