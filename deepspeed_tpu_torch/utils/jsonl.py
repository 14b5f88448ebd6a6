"""Torn-line-tolerant JSONL reading.

The port of the JAX package's ``utils/jsonl.py``.  The event journal
(``runtime/supervision/events.py``) is an append-only JSONL file that may
end in a torn line: the producer can be killed mid-``write``, and readers
may race a live writer.  The contract here is the one ``EventJournal``
writes against:

* one JSON object per line;
* a line that fails to parse (torn tail, interleaved garbage) is skipped,
  never fatal;
* non-dict rows are skipped — consumers index by key immediately.

Dependency-free (stdlib only).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

__all__ = ["read_jsonl"]


def read_jsonl(path: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Read a JSONL file of dict records, skipping torn/garbage lines.

    When ``kind`` is given, only rows whose ``"kind"`` field equals it are
    returned.  A missing file yields an empty list so callers can poll a
    journal that has not been created yet.
    """
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn final line or interleaved garbage
            if not isinstance(rec, dict):
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            out.append(rec)
    return out
