"""Trace replay: seeded arrival traces (``trace``), the open-loop
replay engine and its quiesce accounting (``replay``), the three
scenario families (``scenarios``) and their rows and chaos cells
(``replay_bench``).

The trace, replay and scenario layers import no torch (the REST
harness's children may load them); ``replay_bench`` and the replay
engine load lazily, the row's harness reaching the solver.
"""

from kubernetes_tpu_torch.workloads.scenarios import (
    REPLAY_FAMILIES,
    build_family,
)
from kubernetes_tpu_torch.workloads.trace import (
    Trace,
    TraceEvent,
    generate_trace,
    load_trace_jsonl,
    write_trace_jsonl,
)

__all__ = [
    "Trace", "TraceEvent", "generate_trace",
    "load_trace_jsonl", "write_trace_jsonl",
    "REPLAY_FAMILIES", "build_family",
    "ReplayEngine", "ReplayStats",
    "run_replay_row", "run_replay_cell", "run_replay_once",
]


def __getattr__(name):
    if name in ("ReplayEngine", "ReplayStats"):
        from kubernetes_tpu_torch.workloads import replay

        return getattr(replay, name)
    if name in ("run_replay_row", "run_replay_cell", "run_replay_once"):
        from kubernetes_tpu_torch.workloads import replay_bench

        return getattr(replay_bench, name)
    raise AttributeError(name)
