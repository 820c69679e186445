"""Overload chaos: multi-tenant abuse against the APF-guarded REST
fabric, one seeded cell at a time.

Each cell runs an in-process apiserver with small seat budgets, slowed
further by its ``FaultGate`` (seeded latency on reads, so queues form),
while:

- aggressor tenant threads mount the cell's overload shape: sustained
  list storms, watch reconnect herds, bulk-verb abuse, or all three at
  once (seat saturation);
- a victim tenant posts pod-creation waves and a scheduler (a
  control-plane identity, at the system priority level) binds them;
- a prober hammers the exempt routes (``/healthz``, ``/readyz``,
  ``/metrics``, ``/debug/faults``, ``/debug/apf``) throughout.

The invariants of a cell:

- **zero lost pods**: every victim pod exists and is bound at the end;
  the aggressors may slow the victim, never starve it;
- **exempt always served**: no probe queued or refused, probe latency
  under 2 s;
- **no starved flow**: every aggressor tenant still had requests
  dispatched, and the victim's flow appears;
- **bulk width proportional**: bulk verbs took proportional seats (an
  average dispatched width above 1 when the cell ran bulk abuse);
- **apf engaged** (saturation cells): the workload level reached its
  seat capacity.

The scheduler is the host path (``Scheduler.create``, no batch
scheduler), so a cell needs no card.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.harness.qos import (
    AGGRESSOR_SHAPES,
    _aggressor_thread,
)

SCHED_TOKEN = "overload-sched-token"
VICTIM_TOKEN = "overload-victim-token"

OVERLOAD_PROFILES: Dict[str, Dict] = {
    # shapes cycled across aggressor threads; budgets = (readonly,
    # mutating) lane numbers the APF seat shares derive from
    "liststorm": {"shapes": ("liststorm",), "threads": 8,
                  "budgets": (16, 10)},
    "watchherd": {"shapes": ("watchherd",), "threads": 8,
                  "budgets": (16, 10)},
    "bulkabuse": {"shapes": ("bulkabuse",), "threads": 6,
                  "budgets": (16, 10)},
    "saturation": {"shapes": AGGRESSOR_SHAPES, "threads": 12,
                   "budgets": (8, 6)},
    "mixed": {"shapes": AGGRESSOR_SHAPES, "threads": 9,
              "budgets": (16, 10)},
}


def overload_fault_spec(seed: int) -> Dict:
    """Seeded read-latency profile: slow the server's list/get path so
    seat demand outruns capacity and queues form deterministically."""
    return {
        "seed": seed,
        "rules": [
            {"fault": "latency", "verb": "GET", "probability": 0.35,
             "latency": 0.02},
        ],
    }


def _probe_exempt(url: str, token: str, stop: threading.Event,
                  out: Dict, lock: threading.Lock) -> None:
    """Hammer the exemption envelope for the whole cell; every probe
    must be served immediately — never queued, never 429'd."""
    rest = url.split("://", 1)[1]
    host, _, port = rest.partition(":")
    paths = ("/healthz", "/readyz", "/metrics",
             "/debug/faults", "/debug/apf")
    headers = {"Authorization": f"Bearer {token}"}
    conn: Optional[http.client.HTTPConnection] = None
    i = 0
    while not stop.is_set():
        path = paths[i % len(paths)]
        i += 1
        t0 = time.monotonic()
        try:
            if conn is None:
                conn = http.client.HTTPConnection(host, int(port or 80),
                                                  timeout=10)
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            resp.read()
            status = resp.status
        except Exception:  # noqa: BLE001 — transport blip
            status = -1
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None
        elapsed = time.monotonic() - t0
        with lock:
            out["probes"] += 1
            out["max_latency_s"] = max(out["max_latency_s"], elapsed)
            if status != 200:
                out["failures"].append((path, status))
        time.sleep(0.03)


def run_chaos_overload(
    seed: int,
    nodes: int = 12,
    pods: int = 96,
    node_cpu: int = 16,
    tenants: int = 4,
    waves: int = 4,
    overload_profile: str = "mixed",
    wait_timeout: float = 90.0,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """One seeded overload cell; returns ``{"ok", "invariants",
    "stats"}`` in the chaos-matrix row shape."""
    from kubernetes_tpu_torch.api.serialization import to_wire
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.client.backoff import RetryBudget
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import MakeNode, MakePod

    def note(msg: str) -> None:
        if progress:
            progress(f"overload[{seed}/{overload_profile}]: {msg}")

    profile = OVERLOAD_PROFILES[overload_profile]
    rng = random.Random(seed)
    tenant_tokens = {f"ovl-tenant-{i}-token": f"ovl-tenant-{i}"
                     for i in range(tenants)}
    tokens = {SCHED_TOKEN: "system:kube-scheduler",
              VICTIM_TOKEN: "qos-victim"}
    tokens.update(tenant_tokens)
    ro, mut = profile["budgets"]
    store = ClusterStore()
    server = APIServer(store=store, tokens=tokens,
                       max_readonly_inflight=ro,
                       max_mutating_inflight=mut).start()
    server.fault_gate.configure(overload_fault_spec(seed))
    fc = server.flowcontrol

    stop = threading.Event()
    agg_stats = {"requests": 0, "throttled": 0}
    agg_lock = threading.Lock()
    probe_stats = {"probes": 0, "max_latency_s": 0.0, "failures": []}
    probe_lock = threading.Lock()
    threads: List[threading.Thread] = []
    sched = None
    invariants: Dict[str, bool] = {}
    failure = ""
    try:
        host, _, port = server.url.split("://", 1)[1].partition(":")
        victim = RestClusterClient(
            server.url, token=VICTIM_TOKEN, watch_kinds=(),
            max_retries=10, retry_after_cap=0.5, retry_seed=seed,
            retry_budget=RetryBudget(budget=128, refill_per_second=16.0))
        sched_client = RestClusterClient(
            server.url, token=SCHED_TOKEN,
            max_retries=10, retry_after_cap=0.5, retry_seed=seed + 1,
            retry_budget=RetryBudget(budget=128, refill_per_second=16.0))
        node_objs = [
            MakeNode().name(f"n{i}").capacity(
                {"cpu": str(node_cpu), "memory": "64Gi", "pods": "110"}
            ).obj()
            for i in range(nodes)
        ]
        code, resp = sched_client._request(
            "POST", "/api/v1/nodes",
            {"kind": "NodeList", "items": node_objs}, charge=nodes)
        if code >= 400:
            raise RuntimeError(f"node create failed: {resp}")
        sched = Scheduler.create(sched_client)
        sched.run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and sched.cache.node_count() < nodes:
            time.sleep(0.02)

        # aggressors + exempt prober run for the WHOLE victim workload
        shapes = profile["shapes"]
        tenant_list = list(tenant_tokens)
        for i in range(profile["threads"]):
            token = tenant_list[i % len(tenant_list)]
            t = threading.Thread(
                target=_aggressor_thread,
                args=(host, int(port or 80), token,
                      shapes[i % len(shapes)], seed * 100 + i, stop,
                      agg_stats, agg_lock),
                daemon=True, name=f"aggr-{i}")
            t.start()
            threads.append(t)
        prober = threading.Thread(
            target=_probe_exempt,
            args=(server.url, SCHED_TOKEN, stop, probe_stats, probe_lock),
            daemon=True, name="exempt-probe")
        prober.start()
        threads.append(prober)
        note(f"{nodes} nodes up, {profile['threads']} aggressor "
             f"threads over {tenants} tenants armed")

        per_wave = pods // waves
        created = 0
        for w in range(waves):
            count = per_wave if w < waves - 1 else pods - created
            # the victim is an ordinary tenant: JSON wire dicts (binary
            # bodies are control-plane-only)
            items = [
                to_wire(MakePod().name(f"v{w}-{i}").uid(f"vu{w}-{i}")
                        .req({"cpu": "250m"}).obj())
                for i in range(count)
            ]
            wave_deadline = time.monotonic() + 60
            while True:
                try:
                    code, resp = victim._request(
                        "POST", "/api/v1/namespaces/default/pods",
                        {"kind": "PodList", "items": items},
                        charge=count, body_binary=False)
                except (OSError, RuntimeError) as e:
                    code, resp = 0, e
                if code == 201 and all(
                        f.get("code") == 409
                        for f in (resp.get("failures") or ())):
                    break
                if time.monotonic() > wave_deadline:
                    raise RuntimeError(f"victim wave {w} failed: {resp}")
                time.sleep(0.1)
            created += count
            time.sleep(rng.uniform(0.0, 0.15))

        deadline = time.monotonic() + wait_timeout
        bound = 0
        while time.monotonic() < deadline:
            pods_live = store.list_pods()
            bound = sum(1 for p in pods_live if p.spec.node_name)
            if len(pods_live) >= created and bound >= created:
                break
            time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)

        snap = fc.snapshot()
        workload = snap["levels"]["workload"]
        system = snap["levels"]["system"]

        invariants["zero_lost_pods"] = bound >= created
        if not invariants["zero_lost_pods"]:
            failure = f"bound {bound}/{created} victim pods"

        with probe_lock:
            probe_fail = list(probe_stats["failures"])
            probe_max = probe_stats["max_latency_s"]
            probes = probe_stats["probes"]
        invariants["exempt_always_served"] = (
            probes > 0 and not probe_fail and probe_max < 2.0)
        if not invariants["exempt_always_served"] and not failure:
            failure = (f"exempt probes failed: {probe_fail[:5]} "
                       f"max_latency={probe_max:.2f}s")

        flows = workload.get("flows", {})

        def flow_of(user: str, key: str) -> bool:
            # flow keys are "user" or "user|flow_id" — exact match only
            # (substring matching would let tenant-10's traffic mask a
            # fully starved tenant-1)
            return key == user or key.startswith(user + "|")

        starved = [u for u in tenant_tokens.values()
                   if not any(flow_of(u, k) and n > 0
                              for k, n in flows.items())]
        invariants["no_starved_flow"] = not starved \
            and any(flow_of("qos-victim", k) for k in flows)
        if not invariants["no_starved_flow"] and not failure:
            failure = f"starved flows: {starved[:4] or 'victim'}"

        if "bulkabuse" in shapes:
            # rate equivalence: 200-item bulk verbs must read as width,
            # not as single-seat requests
            disp = max(1, workload["dispatched_total"])
            avg_width = workload["seats_dispatched_total"] / disp
            invariants["bulk_width_proportional"] = avg_width > 1.02
            if not invariants["bulk_width_proportional"] and not failure:
                failure = f"bulk avg width {avg_width:.3f} (laundered?)"

        if overload_profile == "saturation":
            invariants["apf_engaged"] = (
                workload["peak_executing_seats"] >= workload["capacity"])
            if not invariants["apf_engaged"] and not failure:
                failure = (f"workload level never saturated "
                           f"(peak {workload['peak_executing_seats']}"
                           f"/{workload['capacity']})")
    except Exception as e:  # noqa: BLE001 — a crashed cell is a FAIL row
        invariants["no_crash"] = False
        failure = failure or f"{type(e).__name__}: {e}"
        snap = fc.snapshot() if fc is not None else {}
        workload = (snap.get("levels") or {}).get("workload", {})
        system = (snap.get("levels") or {}).get("system", {})
    finally:
        stop.set()
        if sched is not None:
            sched.stop()
        server.shutdown_server()

    with agg_lock:
        agg_requests = agg_stats["requests"]
        agg_throttled = agg_stats["throttled"]
    rejections = sum((workload.get("rejected") or {}).values()) \
        + sum((system.get("rejected") or {}).values())
    return {
        "seed": seed,
        "profile": overload_profile,
        "ok": bool(invariants) and all(invariants.values()),
        "invariants": invariants,
        "failure": failure,
        "stats": {
            "pods": pods,
            "aggressor_requests": agg_requests,
            "aggressor_throttled": agg_throttled,
            "apf_rejections": rejections,
            "faults_injected": server.fault_gate.injected_total(),
            "exempt_probes": probe_stats["probes"],
            "exempt_probe_max_latency_s": round(
                probe_stats["max_latency_s"], 3),
            "workload_peak_seats": workload.get("peak_executing_seats"),
            "workload_capacity": workload.get("capacity"),
        },
    }
