"""The program's own spans, for the per-layer readers.

The program records them in its ``utils/logging`` recorder only while
``torch.profiler`` runs, so only over the profiled stretch (``trace.py``);
a span may carry what one of the program's counter groups gained inside
it.  Each function here returns nothing (``None`` or ``[]``) where the
program has no such recorder or span, or the run was not traced.
"""

from __future__ import annotations

import importlib
from typing import List, Optional

from h100_bench import harness


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        log = importlib.import_module(harness.PROGRAM + ".utils.logging")
    except ImportError:
        return None
    return getattr(log, "RECORDER", None)


def profiled(rec, name: str) -> List:
    """The first ``rec.trace.steps`` spans ``name``: one a step of the
    stretch's device-only pass (the step after it, which records host ops
    too, is left out); none unless there is one for each of those steps."""
    r = recorder()
    if rec.trace is None or r is None:
        return []
    got = r.spans(name)[:rec.trace.steps]
    return got if len(got) == rec.trace.steps else []


def mean_ms(rec, name: str) -> Optional[float]:
    """Mean duration of the profiled steps' spans ``name``, ms."""
    got = profiled(rec, name)
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / len(got) / 1e6


def mean_count_ms(rec, name: str, key: str) -> Optional[float]:
    """Mean over the profiled steps' spans ``name`` of the nanoseconds
    their counter ``key`` gained, ms."""
    got = profiled(rec, name)
    counts = [getattr(s, "counts", None) for s in got]
    if not got or any(c is None or key not in c for c in counts):
        return None
    return sum(c[key] for c in counts) / len(counts) / 1e6
