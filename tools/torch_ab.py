"""Parent against change on the card: the rows a batch-loop change moves.

Runs, from the PyTorch package found under ``--tree`` (a checkout of the
repo; by default this one), SchedulingBasic at 5,000 nodes / 30,000 pods,
the sustained-arrival row (30,000 pods offered at 5,000/s) and Preemption
at 5,000 / 5,000 / 5,000, each in its default arms (pipelined, mirror
on), through the same harness calls ``chip_smoke.py`` makes. Checks that
every measured pod is bound (and, on the sustained row, none lost), and
prints one JSON line: the card, and per row pods/s and latency
percentiles. The kernels are built before the first row.

Compare two commits in one call, in turns, one process a run:

    git archive <parent> | tar -x -C chip_proof/parent
    for t in chip_proof/parent . . chip_proof/parent; do
        python3 tools/torch_ab.py --tree $t; done

Imports ``torch`` and the package under ``--tree`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROWS = ("basic", "sustained", "preemption")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _percentiles(p: dict) -> dict:
    return {k: p[k] for k in ("Perc50", "Perc90", "Perc99") if k in p}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=".",
                    help="the checkout whose package runs")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated, of " + ", ".join(ROWS))
    ap.add_argument("--pin-chunk", action="store_true",
                    help="run_workload(..., adaptive_chunk=False): drains "
                         "and pads at max_batch, on the basic and "
                         "preemption rows (a tree with the tuner)")
    args = ap.parse_args()
    pin = {"adaptive_chunk": False} if args.pin_chunk else {}
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from kubernetes_tpu_torch.harness import perf, sustained, workloads
    from kubernetes_tpu_torch.ops import solve as solve_mod

    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    assert solve_mod.__file__.startswith(tree), solve_mod.__file__
    t0 = time.monotonic()
    solve_mod.build_kernel()
    out = {"tree": args.tree, "pin_chunk": args.pin_chunk, "card": _card(),
           "build_s": time.monotonic() - t0}
    for row in args.rows.split(","):
        t0 = time.monotonic()
        if row == "basic":
            res = perf.run_workload(
                "SchedulingBasic",
                workloads.make_workload("SchedulingBasic", 5000, 0, 30000),
                max_batch=4096, device="cuda", **pin)
            if len(res.placements) != 30000 or not all(
                    res.placements.values()):
                sys.exit("SchedulingBasic: a pod left unbound")
            out[row] = {"pods_per_s": res.pods_per_second,
                        "duration_s": res.duration_seconds,
                        "enqueue_to_bind_ms": _percentiles(res.latency),
                        "solve_to_bind_ms": _percentiles(res.metrics),
                        "solves": res.solves, "host_seconds": res.seconds,
                        "chunk": getattr(res, "chunk", None)}
        elif row == "sustained":
            got = sustained.run_sustained_row(
                pods=30000, qps=5000.0, seed=14, node_cpu=32,
                max_batch=4096, device="cuda")
            if got["lost_pods"] or got["injected"] != 30000:
                sys.exit(f"sustained: {got['lost_pods']} lost, "
                         f"{got['injected']} injected")
            out[row] = {"pods_per_s": got["value"],
                        "p50_arrival_to_bind_ms":
                            got["p50_arrival_to_bind_ms"],
                        "p99_arrival_to_bind_ms":
                            got["p99_arrival_to_bind_ms"],
                        "rate_normalized":
                            got["rate_normalized_throughput"],
                        "solves": got["session"]["solves"]}
        elif row == "preemption":
            res = perf.run_workload(
                "Preemption", workloads.preemption(5000, 5000, 5000),
                max_batch=4096, device="cuda", seed=11, **pin)
            measured = [f"pod-{5000 + i}" for i in range(5000)]
            if not all(res.placements.get(n) for n in measured):
                sys.exit("Preemption: a measured pod left unbound")
            out[row] = {"pods_per_s": res.pods_per_second,
                        "duration_s": res.duration_seconds,
                        "enqueue_to_bind_ms": _percentiles(res.latency),
                        "victims": res.victims, "solves": res.solves,
                        "host_paths": res.host_paths,
                        "chunk": getattr(res, "chunk", None)}
        else:
            sys.exit(f"unknown row {row!r}")
        out[row]["wall_s"] = time.monotonic() - t0
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
