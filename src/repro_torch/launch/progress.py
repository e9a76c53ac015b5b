"""The ``progress.jsonl`` audit trail of the resumable launchers (the
port's copy of ``repro.launch.progress``).

``launch/quantize.py`` persists one JSON record per completed block and
must tolerate a run killed mid-write (a torn or empty last line) without
masking real corruption.
"""

from __future__ import annotations

import json
import os

__all__ = ["load_progress", "append_record"]


def load_progress(path: str) -> list:
    """Parse a ``progress.jsonl`` audit trail, tolerating a truncated tail.

    A run killed mid-write leaves a partial (or empty) last line; resume
    must report from the last *complete* record rather than crash on the
    torn one.  Any undecodable line after the last complete record is
    dropped; an undecodable line *followed by* complete records means real
    corruption and still raises (same policy as the train CLI's
    empty-metrics handling: degrade on torn tails, never mask corruption).
    """
    if not os.path.exists(path):
        return []
    records, bad_at = [], None
    with open(path) as f:
        for n, ln in enumerate(f):
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                if bad_at is None:
                    bad_at = n
                continue
            if bad_at is not None:
                raise ValueError(
                    f"{path}: undecodable record at line {bad_at + 1} "
                    "followed by later records — corrupt, not truncated"
                )
            records.append(rec)
    return records


def append_record(path: str, rec: dict):
    """Append one record; flush so a crash tears at most the last line
    (exactly the failure mode :func:`load_progress` tolerates)."""
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
