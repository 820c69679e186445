"""The elastic bench: the cluster starts at a share of the capacity a
burst needs, and the cluster autoscaler buys the rest while the burst is
pending, so pods/s and time-to-all-bound include the wait for capacity.

One run: an in-process store; the scheduler's batch loop on ``device``
(the card unless "cpu") on a thread of its own; the ``ClusterAutoscaler``
reading the scheduling queue's parked pods, its what-if solves on the
same device; the ``SimulatedProvisioner`` adding real nodes after the
boot latency. The burst comes from ``harness/burst.py``."""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.autoscaler.controller import ClusterAutoscaler
from kubernetes_tpu_torch.autoscaler.nodegroups import (
    NodeGroup,
    NodeGroupRegistry,
)
from kubernetes_tpu_torch.client.informers import SharedInformerFactory
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.harness.burst import (
    make_burst_pods,
    run_pending_burst,
)
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler, attach_batch_scheduler


def _batch_loop(sched: Scheduler, bs: BatchScheduler,
                stop: threading.Event) -> None:
    """Run batches until ``stop``: pods parked past their backoff or the
    unschedulable timeout are retried, and a held batch is committed."""
    while not stop.is_set():
        sched.queue.flush_backoff_completed()
        sched.queue.flush_unschedulable_left_over()
        if not bs.run_batch(pop_timeout=0.05):
            time.sleep(0.002)
    bs.flush()


def run_autoscale_bench(
    burst: int = 1000,
    pod_cpu_milli: int = 500,
    pod_memory: str = "500Mi",
    node_cpu: int = 16,
    node_memory: str = "64Gi",
    initial_fraction: float = 0.2,
    boot_latency: float = 0.0,
    max_batch: int = 1024,
    expander: str = "least-waste",
    scale_down: bool = False,
    wait_timeout: float = 600.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
    configure=None,
) -> Dict:
    """One elastic run: the cluster at ``initial_fraction`` of the nodes
    the burst needs, a burst of ``burst`` pods, the autoscaler filling
    the gap. ``configure(autoscaler, batch_scheduler)`` runs before the
    burst. Returns a bench row."""
    dev = resolve_device(device)

    def note(msg: str) -> None:
        if progress:
            progress(f"elastic: {msg}")

    # a node holds the fewer of its cpu's pods and the template's 110;
    # two nodes of slack keep the max size out of the estimate's way
    per_node = max(1, min(node_cpu * 1000 // pod_cpu_milli, 110))
    needed = max(1, math.ceil(burst / per_node))
    initial = max(1, math.ceil(initial_fraction * needed))
    store = ClusterStore()
    registry = NodeGroupRegistry()
    group = registry.add(NodeGroup(
        "ng-elastic", cpu=str(node_cpu), memory=node_memory,
        min_size=initial, max_size=needed + 2, boot_latency=boot_latency))
    for i in range(initial):
        store.add_node(group.node_template(i))

    factory = SharedInformerFactory(store)
    ca = ClusterAutoscaler(store, factory, registry=registry, device=dev)
    ca.RESYNC_SECONDS = 0.1
    ca.scale_up_cooldown = 0.5
    ca.expander = expander
    # cover the gap in few rounds; a round is still one solve a group
    ca.max_virtual_per_group = min(256, needed + 2)
    ca.scale_down_enabled = scale_down

    sched = Scheduler(store, rng=random.Random(0),
                      feature_gates=FeatureGates({"TPUBatchScheduler": True}))
    bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev)
    ca.queue_introspect = sched.queue
    if configure is not None:
        configure(ca, bs)
    stop = threading.Event()
    loop = threading.Thread(target=_batch_loop, args=(sched, bs, stop),
                            daemon=True, name="elastic-batch-loop")
    result = None
    try:
        sched.start()
        factory.start()
        factory.wait_for_cache_sync()
        ca.run()
        warm = bs.warmup(make_burst_pods(
            min(64, burst), cpu_milli=pod_cpu_milli, memory=pod_memory,
            name_prefix="warm-", uid_prefix="w-"))
        note(f"solver warm-up {warm:.2f}s")
        loop.start()
        note(f"{initial}/{needed} nodes up, bursting {burst} pods "
             f"(boot latency {boot_latency}s)")
        result = run_pending_burst(
            store, burst, timeout=wait_timeout, cpu_milli=pod_cpu_milli,
            memory=pod_memory, name_prefix="eb-", uid_prefix="ebu-",
            safe_to_evict=True, progress=progress)
        note(f"{result.bound}/{burst} bound, t={result.time_to_all_bound}")
    finally:
        stop.set()
        if loop.is_alive():
            loop.join(timeout=60.0)
        ca.stop()
        sched.wait_for_inflight_bindings(timeout=10.0)
        sched.stop()
        factory.stop()

    final_nodes = len(store.list_nodes())
    row = {
        "metric": (f"pods_scheduled_per_sec[autoscale {initial}->"
                   f"{final_nodes}nodes/{burst}pods, boot {boot_latency}s, "
                   f"batch path on {dev.type}]"),
        "value": round(result.pods_per_second, 1) if result else 0.0,
        "unit": "pods/s",
        "time_to_all_bound_s": (
            round(result.time_to_all_bound, 2)
            if result and result.time_to_all_bound is not None else None),
        "bound": result.bound if result else 0,
        "needed": needed,
        "nodes_start": initial,
        "nodes_end": final_nodes,
        "scaleup_decisions": ca.scale_up_events,
        "nodes_provisioned": ca.provisioner.provisioned_total,
        "whatif_solves": ca.whatif_solves,
        "batch_solves": bs.session.backend.solves,
        # host seconds: the autoscaler's what-ifs (encode, solve and
        # read-back included); the batch loop's session (encode, device
        # wait, scatters), commit and side paths (the declined pods'
        # statuses and PostFilter: "fail")
        "host_seconds": {"whatif": ca.whatif_seconds,
                         **bs.session.seconds, "commit": bs.seconds_commit,
                         **bs.seconds},
        "expander": expander,
        "device": str(dev),
    }
    if result and result.time_to_all_bound is None:
        row["error"] = f"timeout: {result.bound}/{burst} bound"
    return row


def run_scale_cell(burst: int, boot_latency: float, repeats: int = 2,
                   wait_timeout: float = 120.0,
                   progress: Optional[Callable[[str], None]] = None,
                   **kwargs) -> Dict:
    """``repeats`` elastic runs at one (burst, boot latency); the worst
    time to capacity (the p99 of few runs) and the median."""
    samples: List[float] = []
    rows = []
    failure = ""
    for _ in range(repeats):
        row = run_autoscale_bench(burst=burst, boot_latency=boot_latency,
                                  wait_timeout=wait_timeout,
                                  progress=progress, **kwargs)
        rows.append(row)
        if row.get("time_to_all_bound_s") is None:
            failure = row.get("error", "timeout")
        else:
            samples.append(row["time_to_all_bound_s"])
    return {
        "ok": len(samples) == repeats,
        "failure": failure,
        "burst": burst,
        "boot_latency": boot_latency,
        "stats": {
            "runs": repeats,
            "time_to_capacity_p99_s": max(samples) if samples else None,
            "time_to_capacity_p50_s": (sorted(samples)[(len(samples) - 1)
                                                       // 2]
                                       if samples else None),
            "pods_per_s_min": min((r["value"] for r in rows), default=0.0),
            "scaleup_decisions": sum(r["scaleup_decisions"] for r in rows),
            "nodes_provisioned": sum(r["nodes_provisioned"] for r in rows),
        },
    }
