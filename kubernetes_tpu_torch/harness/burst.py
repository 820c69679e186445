"""Pending bursts and open-loop arrival injection: a burst of N plain
pods (``workloads.basic_pod`` shapes, named and uid'd by prefix,
optionally safe to evict) admitted at once and waited on until every one
is bound (``run_pending_burst``); the loop that sends items on a clock
(nothing waits for binds); the bulk admission of one chunk of pods; and
the exact-sample percentile the replay engine reports."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from kubernetes_tpu_torch.api.types import FAILED, SUCCEEDED, Pod
from kubernetes_tpu_torch.autoscaler.nodegroups import (
    SAFE_TO_EVICT_ANNOTATION,
)
from kubernetes_tpu_torch.harness.workloads import basic_pod


def make_burst_pods(count: int, cpu_milli: int = 500, memory: str = "500Mi",
                    name_prefix: str = "burst-", uid_prefix: str = "bu-",
                    safe_to_evict: bool = False) -> List[Pod]:
    """Pods ``{name_prefix}{i}`` (uid ``{uid_prefix}{i}``) for i in
    [0, count), each requesting ``cpu_milli`` and ``memory``; with
    ``safe_to_evict`` a drain may evict them."""
    out: List[Pod] = []
    for i in range(count):
        d = basic_pod(i, cpu=f"{cpu_milli}m", memory=memory)
        d["metadata"]["name"] = f"{name_prefix}{i}"
        pod = Pod.from_dict(d)
        pod.metadata.uid = f"{uid_prefix}{i}"
        if safe_to_evict:
            pod.metadata.annotations[SAFE_TO_EVICT_ANNOTATION] = "true"
        out.append(pod)
    return out


@dataclass
class BurstResult:
    injected: int
    bound: int
    time_to_all_bound: Optional[float]   # None: timed out

    @property
    def pods_per_second(self) -> float:
        if not self.time_to_all_bound:
            return 0.0
        return self.injected / self.time_to_all_bound


def sample_percentile(samples: Sequence[float], q: float) -> float:
    """The sample at index ``int(len * q)`` of the sorted samples
    (clamped; 0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * q), len(s) - 1)]


def create_chunk(store, pods: Sequence[Pod]) -> None:
    """Admit one chunk of pods in one call: the in-process store's
    ``create_pods``, or a REST client's bulk verb (a ``PodList`` POST)."""
    create_bulk = getattr(store, "create_pods", None)
    if create_bulk is not None:
        create_bulk(list(pods))
    else:
        store.create_objects_bulk("Pod", list(pods))


def stream_arrivals(
    arrivals,
    send: Callable[[List], None],
    *,
    chunk: int = 512,
    time_scale: float = 1.0,
    flush_window: float = 0.0,
    clock: Callable[[], float] = time.monotonic,
    stop=None,
    on_sent: Optional[Callable[[object, float], None]] = None,
) -> int:
    """Send ``(due_s, item)`` pairs, ordered by ``due_s``, when they fall
    due, in chunks of at most ``chunk``: an item is sent once its time
    has come, whatever became of earlier ones. ``time_scale`` stretches
    the clock (0 sends everything at once); items due within
    ``flush_window`` ride the same send; ``on_sent(item, offset_s)``
    stamps each item with its real send offset; ``stop`` (an Event)
    aborts between sends. Returns the items sent."""
    t0 = clock()
    sent = 0
    batch: List = []

    def flush() -> None:
        nonlocal sent, batch
        while batch:
            part, batch = batch[:chunk], batch[chunk:]
            send(part)
            now_off = clock() - t0
            if on_sent is not None:
                for item in part:
                    on_sent(item, now_off)
            sent += len(part)

    for due_s, item in arrivals:
        if stop is not None and stop.is_set():
            break
        due = due_s * time_scale
        while True:
            wait = due - (clock() - t0) - flush_window
            if wait <= 0:
                break
            if batch:
                flush()
            if stop is not None and stop.is_set():
                return sent
            time.sleep(min(wait, 0.05))
        batch.append(item)
        if len(batch) >= chunk:
            flush()
    flush()
    return sent


def count_bound(store, names: Sequence[str]) -> int:
    """The named pods bound or terminal, by name (a replacement with the
    same name counts)."""
    wanted = set(names)
    n = 0
    for pod in store.list_pods():
        if pod.metadata.name not in wanted:
            continue
        if pod.spec.node_name or pod.status.phase in (SUCCEEDED, FAILED):
            n += 1
    return n


def wait_all_bound(store, names: Sequence[str], timeout: float,
                   poll: float = 0.05,
                   progress: Optional[Callable[[str], None]] = None
                   ) -> Optional[float]:
    """Seconds until every named pod is bound (or terminal); None on
    timeout."""
    t0 = time.monotonic()
    deadline = t0 + timeout
    last_report = 0
    while time.monotonic() < deadline:
        bound = count_bound(store, names)
        if bound >= len(names):
            return time.monotonic() - t0
        if progress and bound - last_report >= max(50, len(names) // 20):
            last_report = bound
            progress(f"burst: {bound}/{len(names)} bound")
        time.sleep(poll)
    return None


def run_pending_burst(store, count: int, timeout: float = 120.0,
                      progress: Optional[Callable[[str], None]] = None,
                      **make_kwargs) -> BurstResult:
    """Admit ``count`` pods (``make_burst_pods(count, **make_kwargs)``) in
    one store call, then wait until every one is bound."""
    pods = make_burst_pods(count, **make_kwargs)
    names = [p.metadata.name for p in pods]
    stream_arrivals(((0.0, p) for p in pods),
                    lambda chunk_pods: create_chunk(store, chunk_pods),
                    chunk=max(len(pods), 1), time_scale=0.0)
    elapsed = wait_all_bound(store, names, timeout, progress=progress)
    return BurstResult(injected=count, bound=count_bound(store, names),
                       time_to_all_bound=elapsed)
