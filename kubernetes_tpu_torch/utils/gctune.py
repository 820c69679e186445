"""Cyclic-GC tuning for throughput phases.

At benchmark scale (tens of thousands of pods, each a graph of small API
objects) Python's default gen-0 threshold of 700 allocations makes the
cyclic collector run all through admission and commit. The API objects
hold no reference cycles, so reference counting frees them; the cyclic
collector stays on but scans rarely, and the heap built before the
phase is frozen out of its scans.
"""

from __future__ import annotations

import gc

_TUNED = False


def tune_for_throughput(freeze: bool = True) -> None:
    """Raise the GC thresholds and (``freeze``) move the current heap
    out of the collector's scans. Once a process; later calls do
    nothing."""
    global _TUNED
    if _TUNED:
        return
    if freeze:
        gc.collect()
        gc.freeze()
    gc.set_threshold(100_000, 100, 100)
    _TUNED = True
