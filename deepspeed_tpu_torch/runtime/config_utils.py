"""The typed-config base class.

Counterpart of ``deepspeed/runtime/config_utils.py``'s
``DeepSpeedConfigModel``: a small dataclass model with dict round-tripping
and deprecated-field aliasing.  Unlike the JAX package's copy, an unknown
key raises: a typo in a serving config must not be silently dropped.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Type, TypeVar

from ..utils.logging import logger

T = TypeVar("T", bound="DeepSpeedConfigModel")


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Dataclass base with dict round-tripping.

    Subclasses may declare ``DEPRECATED_FIELDS = {"old_key": "new_key"}``;
    old keys in the input dict are remapped with a warning.
    """

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]] = None,
                  **overrides) -> T:
        data = dict(data or {})
        data.update(overrides)
        for old, new in dict(getattr(cls, "DEPRECATED_FIELDS", {})).items():
            if old in data:
                logger.warning(
                    f"Config parameter {old} is deprecated, use {new} instead")
                data.setdefault(new, data.pop(old))
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(k for k in data if k not in field_names)
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown config keys {unknown} "
                f"(known: {sorted(field_names)})")
        return cls(**data)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{type(self).__name__}({json.dumps(self.to_dict(), default=str)})"
