"""Pluggable checkpoint backend ABC.

The port of the JAX package's ``runtime/checkpoint_engine/
checkpoint_engine.py`` (the reference's Torch/Nebula interface).  The
implementations: ``NativeCheckpointEngine`` (sync, numpy ``.npz``) and
``AsyncCheckpointEngine`` (background writer threads + deferred publish),
selected via ``{"checkpoint": {"async_save": true}}``.
"""

from __future__ import annotations

from typing import Any, Optional


class CheckpointEngine:
    def __init__(self, config_params=None):
        #: raw or typed "checkpoint" section; implementations parse it into
        #: a DeepSpeedCheckpointConfig (retry policy, integrity, retention)
        self.config_params = config_params

    def create(self, tag: str) -> None:
        """Log/prepare for a checkpoint under ``tag``."""

    def save(self, state_dict: Any, path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Any:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Flush/fsync everything belonging to ``tag``; True on success."""
        return True
