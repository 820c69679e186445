"""The cache debugger (upstream ``pkg/scheduler/internal/cache/debugger``,
wired to SIGUSR2): on demand or on the signal, dump the cache's nodes and
pods and the queue's pods to the log, and compare the cache against the
store (the nodes and bound pods each holds that the other lacks; an
assumed pod not yet in the store is no drift).
"""

from __future__ import annotations

import logging
import signal
import threading
from dataclasses import dataclass, field
from typing import Dict, List

_logger = logging.getLogger(__name__)


@dataclass
class ComparisonResult:
    """Differences between cache and the authoritative store."""

    missing_nodes: List[str] = field(default_factory=list)   # in store, not cache
    redundant_nodes: List[str] = field(default_factory=list)  # in cache, not store
    missing_pods: List[str] = field(default_factory=list)
    redundant_pods: List[str] = field(default_factory=list)

    @property
    def consistent(self) -> bool:
        return not (
            self.missing_nodes or self.redundant_nodes
            or self.missing_pods or self.redundant_pods
        )


class CacheDebugger:
    def __init__(self, store, cache, queue):
        self.store = store
        self.cache = cache
        self.queue = queue

    # -- dumper (debugger/dumper.go) -----------------------------------
    def dump(self) -> Dict:
        """Snapshot of cache nodes/pods + queue contents, log-friendly."""
        cached = self.cache.dump()
        nodes = {}
        for name, info in cached["nodes"].items():
            nodes[name] = {
                "pods": [p.pod.full_name() for p in info.pods],
                "requested_milli_cpu": info.requested.milli_cpu,
                "requested_memory": info.requested.memory,
                "generation": info.generation,
            }
        pending = self.queue.pending_pods()
        return {
            "nodes": nodes,
            "assumed_pods": sorted(cached["assumed_pods"]),
            "pending_pods": [p.full_name() for p in pending],
        }

    def dump_to_log(self) -> None:
        d = self.dump()
        _logger.info("cache dump: %d nodes, %d assumed, %d pending",
                     len(d["nodes"]), len(d["assumed_pods"]),
                     len(d["pending_pods"]))
        for name, info in d["nodes"].items():
            _logger.info("node %s: %s", name, info)

    # -- comparer (debugger/comparer.go) -------------------------------
    def compare(self) -> ComparisonResult:
        """Cache vs store ground truth. Assumed pods are expected to be
        cache-only until their binding lands — not drift."""
        result = ComparisonResult()
        cached = self.cache.dump()
        store_nodes = {n.name for n in self.store.list_nodes()}
        cache_nodes = set(cached["nodes"])
        result.missing_nodes = sorted(store_nodes - cache_nodes)
        result.redundant_nodes = sorted(cache_nodes - store_nodes)

        store_pods = {
            p.full_name() for p in self.store.list_pods() if p.spec.node_name
        }
        cache_pods = set()
        for info in cached["nodes"].values():
            for p in info.pods:
                cache_pods.add(p.pod.full_name())
        assumed = cached["assumed_pods"]
        result.missing_pods = sorted(store_pods - cache_pods)
        result.redundant_pods = sorted(
            k for k in cache_pods - store_pods if k not in assumed
        )
        return result

    # -- signal wiring (debugger/signal.go) ----------------------------
    def listen_for_signal(self, signum: int = signal.SIGUSR2) -> bool:
        """Install the dump-and-compare handler for ``signum``; only the
        main thread can, so elsewhere this returns False."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def handler(sig, frame):
            self.dump_to_log()
            result = self.compare()
            if not result.consistent:
                _logger.warning("cache inconsistent vs store: %s", result)

        signal.signal(signum, handler)
        return True
