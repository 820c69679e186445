"""Host seconds of the cluster autoscaler's what-if, outside the solve.

A what-if snapshots every bound pod, then encodes the pending sample
with the virtual columns (``autoscaler/simulator.py::run_whatif``). This
times both at the autoscale row's scale (32-cpu nodes of 64 pods of
500m; ``--bound`` bound pods, a 2,048-pod pending sample, K = 256
virtual columns): the snapshot of pod objects it has not seen (each
pod's PodInfo computed, and memoized on the pod object), the snapshot
again (the memo warm, as for pods a what-if saw before), and the
encode. Prints one JSON line of seconds, each the median of
``--repeats`` runs but the first snapshot's. Host code only: runs
anywhere.

    python3 tools/whatif_host.py [--bound 18000]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kubernetes_tpu_torch.autoscaler.nodegroups import NodeGroup  # noqa: E402
from kubernetes_tpu_torch.harness.burst import make_burst_pods  # noqa: E402
from kubernetes_tpu_torch.ops.encode import BatchEncoder  # noqa: E402
from kubernetes_tpu_torch.scheduler.snapshot import (  # noqa: E402
    new_snapshot,
)


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bound", type=int, default=18000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    group = NodeGroup("ng", cpu="32", memory="64Gi", max_size=471)
    nodes = [group.node_template(i) for i in range(-(-args.bound // 64))]
    bound = make_burst_pods(args.bound, name_prefix="b-", uid_prefix="bu-")
    for i, pod in enumerate(bound):
        pod.spec.node_name = f"ng-{i // 64}"
    pending = make_burst_pods(2048, name_prefix="p-", uid_prefix="pu-")
    virtual = [group.node_template(f"whatif-{i}") for i in range(256)]
    first = _seconds(lambda: new_snapshot(bound, nodes))
    snap = new_snapshot(bound, nodes)
    print(json.dumps({
        "bound_pods": args.bound,
        "snapshot_first_s": first,
        "snapshot_s": statistics.median(
            _seconds(lambda: new_snapshot(bound, nodes))
            for _ in range(args.repeats)),
        "encode_s": statistics.median(
            _seconds(lambda: BatchEncoder(snap, extra_nodes=virtual).encode(
                pending, pad_pods=2048)) for _ in range(args.repeats)),
    }))


if __name__ == "__main__":
    main()
