"""The noisy-tenant QoS row: the REST row's 30,000-pod burst while
hostile tenants hammer the apiserver, with API Priority and Fairness
(APF) as the thing under test.

``run_noisy_tenant_qos`` runs the SchedulingBasic REST workload in two
arms at one size:

- **solo**: plain ``run_workload_rest``, the victim's baseline (or the
  numbers of a REST row run beside it, passed as ``solo_baseline``);
- **contended**: the same victim while ``tenants`` aggressor processes,
  armed as the measurement starts, each an authenticated workload-level
  tenant, mount three overload shapes from several threads: sustained
  list storms, watch reconnect herds and bulk-verb abuse (200-item
  ``ConfigMapList`` POSTs), honouring nothing but their own 429s.

APF routes the victim's control-plane traffic (the scheduler's binds
and status writes, the creators of ``system:masters``) past the
aggressors' workload level, and fair queuing inside that level keeps
the aggressors from starving each other. The row reports both arms'
pods/s and e2e p99, their ratio and the apiserver's ``/debug/apf``
totals; ``qos_ok`` is ``p99_contended <= 2 x p99_solo`` with every pod
bound in both arms.

The aggressors are spawned processes speaking raw ``http.client``: no
client-side rate limit, no decoding, only request pressure. They import
nothing but this module and the standard library (no torch).
"""

from __future__ import annotations

import http.client
import json
import multiprocessing as mp
import random
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

AGGRESSOR_SHAPES = ("liststorm", "watchherd", "bulkabuse")


def tenant_tokens(tenants: int) -> Dict[str, str]:
    """Bearer token -> user of each aggressor tenant."""
    return {f"qos-tenant-{i}-token": f"qos-tenant-{i}"
            for i in range(tenants)}


# ---------------------------------------------------------------------------
# the aggressor child (spawned; it imports no torch)


def _aggressor_thread(host: str, port: int, token: str, shape: str,
                      seed: int, stop, stats: dict, lock) -> None:
    """One aggressor thread mounting ``shape`` until ``stop`` is set;
    ``stats`` counts its requests and the 429s among them."""
    rng = random.Random(seed)
    headers = {"Authorization": f"Bearer {token}"}
    bin_headers = dict(headers)
    bin_headers["Accept"] = "application/vnd.ktpu.binary"
    conn: Optional[http.client.HTTPConnection] = None
    seq = 0
    while not stop.is_set():
        try:
            if conn is None:
                conn = http.client.HTTPConnection(host, port, timeout=30)
            if shape == "liststorm":
                # sustained expensive lists: the shape APF's width
                # estimate prices by the list sizes recently served
                conn.request("GET", rng.choice(
                    ("/api/v1/pods", "/api/v1/nodes")),
                    headers=bin_headers)
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            elif shape == "watchherd":
                # a reconnect herd: attach (the headers come as soon as
                # the stream attaches, which is what charges the
                # watch-init seats), linger a moment, drop, again
                conn.request(
                    "GET", "/api/v1/pods?watch=1&resourceVersion=0",
                    headers=headers)
                resp = conn.getresponse()
                status = resp.status
                time.sleep(rng.uniform(0.0, 0.02))
                conn.close()
                conn = None
            else:   # bulkabuse: wide bulk verbs, whose width must scale
                seq += 1
                items = [{"metadata": {
                    "name": f"ld-{seed}-{seq}-{i}",
                    "namespace": "default"}}
                    for i in range(200)]
                body = json.dumps({"kind": "ConfigMapList",
                                   "items": items}).encode()
                h = dict(headers)
                h["Content-Type"] = "application/json"
                h["X-Kubernetes-Request-Items"] = "200"
                conn.request("POST", "/api/v1/configmaps", body=body,
                             headers=h)
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            with lock:
                stats["requests"] += 1
                if status == 429:
                    stats["throttled"] += 1
            if status == 429:
                time.sleep(0.02)    # hostile, but not a pure spin
        except Exception:  # noqa: BLE001 — the server pushed back hard
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None
            time.sleep(0.02)


def _aggressor_main(url: str, token: str, seed: int, stop,
                    threads: int = 6, ready=None, report=None) -> None:
    """An aggressor process: ``threads`` threads cycling the shapes.
    ``ready`` is set once they fire; ``report`` (a pipe end) gets the
    process's request counts and whether it imported torch at the end."""
    rest = url.split("://", 1)[1]
    host, _, port = rest.partition(":")
    stats = {"requests": 0, "throttled": 0}
    lock = threading.Lock()
    workers = [
        threading.Thread(
            target=_aggressor_thread,
            args=(host, int(port or 80), token,
                  AGGRESSOR_SHAPES[i % len(AGGRESSOR_SHAPES)],
                  seed * 1000 + i, stop, stats, lock),
            daemon=True)
        for i in range(threads)
    ]
    for w in workers:
        w.start()
    if ready is not None:
        # a spawn takes a second or more: the parent waits for this so
        # the contended arm never measures an uncontended server
        ready.set()
    stop.wait()
    for w in workers:
        w.join(timeout=2.0)
    if report is not None:
        with lock:
            report.send(dict(stats, torch="torch" in sys.modules))


# ---------------------------------------------------------------------------
# the row


def _apf_summary(snap: Optional[dict]) -> dict:
    """The ``/debug/apf`` snapshot's totals: rejections over every level,
    and each level's dispatched requests and seats, rejections, peak
    executing seats and capacity."""
    if not snap:
        return {}
    out = {"rejections": 0, "levels": {}}
    for name, lv in (snap.get("levels") or {}).items():
        rejected = sum((lv.get("rejected") or {}).values())
        out["rejections"] += rejected
        out["levels"][name] = {
            "dispatched": lv.get("dispatched_total", 0),
            "seats_dispatched": lv.get("seats_dispatched_total", 0),
            "rejected": rejected,
            "peak_executing_seats": lv.get("peak_executing_seats", 0),
            "capacity": lv.get("capacity", 0),
        }
    return out


def run_noisy_tenant_qos(
    nodes: int,
    measure_pods: int,
    tenants: int = 3,
    qps: Optional[float] = 5000.0,
    max_batch: int = 4096,
    aggressor_threads: int = 6,
    seed: int = 7,
    wait_timeout: float = 1200.0,
    progress: Optional[Callable[[str], None]] = None,
    result_hook=None,
    solo_baseline: Optional[dict] = None,
    device=None,
) -> dict:
    """One QoS row (see the module's docstring), the scheduler's solves
    on ``device`` (the card unless "cpu" is passed). Returns the row's
    dict; ``qos_ok`` is its verdict. ``solo_baseline`` (keys
    ``pods_per_sec``, ``p99_latency_ms``) stands in for the solo arm:
    a REST row of the same size measures the same configuration.
    ``contended`` holds the contended arm's ``BenchmarkResult``."""
    from kubernetes_tpu_torch.harness.rest_perf import (
        _main_hidden,
        run_workload_rest,
    )

    def note(msg: str) -> None:
        if progress:
            progress(f"[qos] {msg}")

    if solo_baseline is not None:
        solo_rate = float(solo_baseline["pods_per_sec"])
        p99_solo = float(solo_baseline["p99_latency_ms"])
        solo_bound = True
        note(f"solo baseline (from the REST row): {solo_rate:.1f} "
             f"pods/s p99 {p99_solo:.0f}ms")
    else:
        note(f"solo arm: SchedulingBasic {nodes} nodes / "
             f"{measure_pods} pods over REST")
        solo = run_workload_rest(
            "SchedulingBasic", nodes=nodes, measure_pods=measure_pods,
            max_batch=min(measure_pods, max_batch), qps=qps,
            wait_timeout=wait_timeout, progress=progress,
            result_hook=result_hook, device=device)
        solo_rate = solo.pods_per_second
        p99_solo = solo.metrics.get("Perc99", 0.0)
        solo_bound = solo.metrics.get("server_pods_bound", 0) \
            >= measure_pods

    tokens = tenant_tokens(tenants)
    ctx = mp.get_context("spawn")
    procs: List = []
    reports: List = []
    stop_evt = ctx.Event()

    def start_aggressors(url: str) -> Callable[[], None]:
        note(f"arming {tenants} aggressor tenants x "
             f"{aggressor_threads} threads (list storms, watch herds, "
             f"bulk abuse)")
        ready_evts = []
        for i, token in enumerate(tokens):
            ready = ctx.Event()
            mine, theirs = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_aggressor_main,
                args=(url, token, seed + i, stop_evt, aggressor_threads,
                      ready, theirs),
                daemon=True)
            with _main_hidden():
                p.start()
            procs.append(p)
            reports.append(mine)
            ready_evts.append(ready)

        def stop() -> None:
            stop_evt.set()
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.terminate()

        # every aggressor fleet fires before the measured window opens
        if not all(ready.wait(60.0) for ready in ready_evts):
            stop()
            raise RuntimeError("an aggressor process never came up")
        note("aggressors firing")
        return stop

    note("contended arm: same victim burst under aggressor load")
    contended = run_workload_rest(
        "SchedulingBasic", nodes=nodes, measure_pods=measure_pods,
        max_batch=min(measure_pods, max_batch), qps=qps,
        wait_timeout=wait_timeout, progress=progress,
        result_hook=result_hook, device=device,
        extra_tokens=tokens, on_measure_start=start_aggressors)
    aggressors = {"requests": 0, "throttled": 0, "reported": 0,
                  "import_torch": False}
    for conn in reports:
        if conn.poll(5.0):
            r = conn.recv()
            aggressors["requests"] += r["requests"]
            aggressors["throttled"] += r["throttled"]
            aggressors["reported"] += 1
            aggressors["import_torch"] |= r["torch"]

    p99_contended = contended.metrics.get("Perc99", 0.0)
    ratio = (p99_contended / p99_solo) if p99_solo > 0 else 0.0
    all_bound = (
        solo_bound
        and contended.metrics.get("server_pods_bound", 0) >= measure_pods)
    apf = _apf_summary(contended.metrics.get("apf"))
    note(f"victim: solo {solo_rate:.1f} pods/s "
         f"p99 {p99_solo:.0f}ms -> contended "
         f"{contended.pods_per_second:.1f} pods/s "
         f"p99 {p99_contended:.0f}ms (ratio {ratio:.2f}); "
         f"apf rejections {apf.get('rejections', 0)}")
    return {
        "metric": f"noisy_tenant_qos[SchedulingBasic {nodes}nodes/"
                  f"{measure_pods}pods, {tenants} aggressor tenants x "
                  f"{aggressor_threads} threads list/watch/bulk]",
        "value": round(contended.pods_per_second, 1),
        "unit": "pods/s",
        "p99_latency_ms": round(p99_contended),
        "solo_pods_per_sec": round(solo_rate, 1),
        "solo_p99_latency_ms": round(p99_solo),
        "p99_ratio_vs_solo": round(ratio, 2),
        "qos_ok": bool(all_bound and (p99_solo <= 0
                                      or p99_contended <= 2.0 * p99_solo)),
        "server_pods_bound": contended.metrics.get("server_pods_bound"),
        "apf": apf,
        "aggressors": aggressors,
        "contended": contended,
    }
