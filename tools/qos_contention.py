"""The REST row's apiserver under the noisy-tenant aggressors, on the
host: how fast a ``system:masters`` creator can post SchedulingBasic
pods while the aggressor processes hammer the server, and where the
server's threads stand while it does.

    python3 tools/qos_contention.py [--nodes 1000] [--pods 15000]
        [--tenants 3] [--threads 6] [--shapes liststorm,watchherd,bulkabuse]
        [--profile]

The apiserver is ``harness.rest_perf._apiserver_main`` (the REST row's
child, with the ``qos-tenant`` role for the aggressors) on a thread of
this process; the aggressors are ``harness.qos._aggressor_main``
processes, as ``run_noisy_tenant_qos`` spawns them (``--shapes none``:
no aggressor). Prints one JSON line: the creator's pods/s and the
aggressors' requests. With ``--profile``, every thread's stack is
sampled every 5 ms and the functions most often on top (where a thread
runs or waits) are printed before it. No scheduler runs: this measures
the fabric's share for the creator, not the row.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing as mp
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _sampler(stop, skip, leaf):
    while not stop.is_set():
        for tid, frame in sys._current_frames().items():
            if tid in skip:
                continue
            code = frame.f_code
            leaf[f"{os.path.basename(code.co_filename)}:{code.co_name}"] += 1
        time.sleep(0.005)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--pods", type=int, default=15000)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--shapes", default="liststorm,watchherd,bulkabuse")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.harness import qos, rest_perf
    from kubernetes_tpu_torch.harness.workloads import make_workload

    tokens = qos.tenant_tokens(args.tenants)
    conn, child = mp.Pipe()
    threading.Thread(target=rest_perf._apiserver_main,
                     args=(child, None, tokens), daemon=True).start()
    url = conn.recv()
    ctx = mp.get_context("spawn")
    stop_evt = ctx.Event()
    procs, reports = [], []
    if args.shapes != "none":
        qos.AGGRESSOR_SHAPES = tuple(args.shapes.split(","))
        for i, token in enumerate(tokens):
            ready = ctx.Event()
            mine, theirs = ctx.Pipe(duplex=False)
            p = ctx.Process(target=qos._aggressor_main,
                            args=(url, token, 7 + i, stop_evt, args.threads,
                                  ready, theirs), daemon=True)
            p.start()
            procs.append(p)
            reports.append(mine)
            ready.wait(60.0)
    creator = RestClusterClient(url, token=rest_perf.CREATOR_TOKEN,
                                qps=5000.0)
    leaf = collections.Counter()
    stop = threading.Event()
    if args.profile:
        threading.Thread(target=_sampler, args=(
            stop, {threading.get_ident()}, leaf), daemon=True).start()
    out = {"nodes": args.nodes, "pods": args.pods,
           "tenants": args.tenants if procs else 0,
           "threads": args.threads, "shapes": args.shapes}
    for op in make_workload("SchedulingBasic", args.nodes, 0, args.pods):
        template = op.get("nodeTemplate") or op.get("podTemplate")
        if op["opcode"] not in ("createNodes", "createPods") or \
                not op["count"]:
            continue
        cls, kind = (Node, "Node") if op["opcode"] == "createNodes" \
            else (Pod, "Pod")
        t0 = time.monotonic()
        for lo in range(0, op["count"], 512):
            creator.create_objects_bulk(kind, [
                cls.from_dict(template(j))
                for j in range(lo, min(op["count"], lo + 512))])
        dt = time.monotonic() - t0
        out[f"{kind.lower()}s_per_s"] = op["count"] / dt
        out[f"{kind.lower()}s_s"] = dt
    stop.set()
    stop_evt.set()
    requests = 0
    for p, r in zip(procs, reports):
        if r.poll(10.0):
            requests += r.recv()["requests"]
        p.join(5.0)
    out["aggressor_requests"] = requests
    creator.close()
    conn.send("stop")
    if args.profile:
        total = max(1, sum(leaf.values()))
        for name, n in leaf.most_common(15):
            print(f"{n / total:.3f} {name}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
