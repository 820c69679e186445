"""Chaos over REST: the wire-level half of the chaos ring.

The apiserver runs as a separate process over a WAL; the FaultGate
injects wire faults (resets, 429 bursts, latency, watch drops) armed at
runtime through ``/debug/faults``; and the apiserver process is
SIGKILLed and restarted from its WAL mid-workload while a real
scheduler keeps binding through ``RestClusterClient``'s resilience stack
(jittered backoff, retry budget, circuit breaker and degraded mode).
The reference is ``test/e2e/chaosmonkey``.

Invariants checked after quiescence:

- **all bound, exactly once**: every created pod exists and is bound;
  the store's bind transaction refuses double binds, so a bound pod on
  a live node with no node oversubscribed proves exactly once;
- **no oversubscription**: per node, the summed cpu requests within
  allocatable, the invariant a confused post-relist cache would break;
- **durability**: a WAL restore in this process reproduces the live
  pod -> node assignment the server reported;
- **resourceVersion monotonicity**: no client observed a list version
  regress across the kill and restart (the restored server continues
  the revision counter, never rewinds it).

The WAL appends inline: every mutation is on disk before its watch
event, and so before any client response, is visible, so a SIGKILL
never loses state a client already observed. ``fsync=True`` puts each
append on stable storage too.

The scheduler takes the serial path (no batch gate), as the JAX cell's
does: this cell touches no device and launches no kernel. The spawned
apiserver child imports no torch (``stats["child_imports_torch"]``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import random
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional


# ---------------------------------------------------------------------------
# the apiserver child (spawned; imports no torch)


def _apiserver_main(conn, wal_dir: str, port: int, fsync: bool) -> None:
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store

    has_state = os.path.exists(os.path.join(wal_dir, "snapshot.json")) \
        or os.path.exists(os.path.join(wal_dir, "wal.jsonl"))
    store = restore_store(wal_dir) if has_state else ClusterStore()
    # inline WAL: durability strictly precedes visibility
    wal = attach_wal(store, wal_dir, fsync=fsync)
    server = APIServer(store=store, port=port).start()
    conn.send(("ready", server.url, "torch" in sys.modules))
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "assignments":
            conn.send({p.uid: p.spec.node_name for p in store.list_pods()})
        elif msg == "counts":
            pods = store.list_pods()
            conn.send({
                "pods_total": len(pods),
                "pods_bound": sum(1 for p in pods if p.spec.node_name),
            })
    server.shutdown_server()
    wal.close()
    conn.send("stopped")


class ChaosApiServer:
    """A kill-and-restartable apiserver subprocess over one WAL
    directory. ``kill()`` is SIGKILL: no goodbye to clients, no WAL
    close; ``restart()`` restores from the WAL on the same port, so
    client URLs stay valid across the crash. ``imports_torch`` is True
    once any incarnation reported torch among its modules."""

    def __init__(self, wal_dir: Optional[str] = None, fsync: bool = False):
        self._ctx = mp.get_context("spawn")
        self._owns_wal = wal_dir is None
        self.wal_dir = wal_dir or tempfile.mkdtemp(prefix="ktpu-chaos-")
        self.fsync = bool(fsync)
        self.port = 0          # the first start picks; restarts reuse it
        self.url: Optional[str] = None
        self.imports_torch = False
        self.starts = 0
        self._proc = None
        self._conn = None

    def start(self, timeout: float = 90.0) -> "ChaosApiServer":
        from kubernetes_tpu_torch.harness.rest_perf import _main_hidden

        conn, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_apiserver_main,
            args=(child, self.wal_dir, self.port, self.fsync), daemon=True)
        with _main_hidden():
            proc.start()
        if not conn.poll(timeout):
            proc.terminate()
            raise TimeoutError("apiserver child did not come up")
        _tag, url, imports_torch = conn.recv()
        self.url = url
        self.port = int(url.rsplit(":", 1)[1])
        self.imports_torch |= bool(imports_torch)
        self.starts += 1
        self._proc, self._conn = proc, conn
        return self

    def kill(self) -> None:
        self._proc.kill()
        self._proc.join(timeout=10.0)
        self._conn.close()
        self._proc = self._conn = None

    def restart(self, timeout: float = 90.0) -> "ChaosApiServer":
        if self._proc is not None:
            self.kill()
        return self.start(timeout)

    def ask(self, msg: str, timeout: float = 30.0):
        self._conn.send(msg)
        if not self._conn.poll(timeout):
            raise TimeoutError(f"apiserver did not answer {msg!r}")
        return self._conn.recv()

    def stop(self, cleanup: bool = True) -> None:
        if self._proc is not None:
            try:
                self._conn.send("stop")
                if self._conn.poll(10.0):
                    self._conn.recv()
            except (OSError, EOFError, BrokenPipeError):
                pass
            self._proc.join(timeout=10.0)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=5.0)
            self._proc = self._conn = None
        if cleanup and self._owns_wal:
            shutil.rmtree(self.wal_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# fault profiles (the seeded matrix chip_smoke's phase_chaos_matrix walks)


def default_fault_spec(seed: int) -> Dict:
    """The mixed profile: resets, 429 bursts and latency on every
    resource, plus watch drops on the pod stream."""
    return {
        "seed": seed,
        "rules": [
            {"fault": "reset", "probability": 0.03},
            {"fault": "error", "probability": 0.05, "code": 429,
             "retry_after": 0.05},
            {"fault": "latency", "probability": 0.10, "latency": 0.01},
            {"fault": "watch_drop", "verb": "GET", "resource": "pods",
             "probability": 0.02},
        ],
    }


FAULT_PROFILES: Dict[str, Callable[[int], Dict]] = {
    "mixed": default_fault_spec,
    "resets": lambda seed: {"seed": seed, "rules": [
        {"fault": "reset", "probability": 0.08},
        {"fault": "truncate", "probability": 0.04, "truncate_bytes": 80},
    ]},
    "pushback": lambda seed: {"seed": seed, "rules": [
        {"fault": "error", "probability": 0.15, "code": 429,
         "retry_after": 0.05},
        {"fault": "error", "probability": 0.05, "code": 503,
         "retry_after": 60.0},   # a hostile Retry-After: the cap must bite
    ]},
    "watchstorm": lambda seed: {"seed": seed, "rules": [
        {"fault": "watch_drop", "probability": 0.05},
        {"fault": "watch_stall", "probability": 0.05, "duration": 0.2},
        {"fault": "latency", "probability": 0.10, "latency": 0.01},
    ]},
}


# ---------------------------------------------------------------------------
# the seeded chaos run


def _tolerable(resp) -> bool:
    """A bulk create whose only failures are 409s succeeded: the retry
    of a request the server applied before it dropped the connection."""
    if not isinstance(resp, dict):
        return False
    return all(f.get("code") == 409 for f in resp.get("failures") or ())


def _retrying(fn, timeout: float = 30.0):
    """``fn()``, retried on transport failures (faults stay armed to the
    end) until ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except (OSError, RuntimeError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def run_chaos_rest(
    seed: int,
    nodes: int = 20,
    pods: int = 120,
    node_cpu: int = 16,
    pod_cpu_milli: int = 500,
    waves: int = 6,
    kill_at_wave: Optional[int] = None,
    fault_profile: str = "mixed",
    qps: Optional[float] = 2000.0,
    wait_timeout: float = 120.0,
    fsync: bool = False,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """One seeded chaos run; returns ``{"ok", "invariants", "failure",
    "stats"}``. Deterministic per (seed, profile): the workload's
    interleaving, the kill point and the server's fault decisions all
    derive from it. No device is touched. ``fsync`` fsyncs each WAL
    append in the apiserver child."""
    from kubernetes_tpu_torch.apiserver.wal import restore_store
    from kubernetes_tpu_torch.client.backoff import RetryBudget
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import MakeNode, MakePod

    def note(msg: str) -> None:
        if progress:
            progress(f"chaos[{seed}/{fault_profile}]: {msg}")

    rng = random.Random(seed)
    spec_fn = FAULT_PROFILES[fault_profile]
    fm = fabric_metrics()
    retries_before = sum(v for _, _, v in fm.client_retries_total.collect())
    degraded_before = fm.degraded_mode_seconds.get()

    t0 = time.monotonic()
    api = ChaosApiServer(fsync=fsync).start()
    sched = None
    faults_injected = 0
    kills = 0
    kill_wave = -1
    invariants: Dict[str, bool] = {}
    failure = ""
    try:
        # generous budgets: the profiles inject faults for the whole
        # run, and the restart window alone eats several retries
        creator = RestClusterClient(
            api.url, qps=qps, watch_kinds=(),
            max_retries=8, retry_after_cap=0.5, retry_seed=seed,
            retry_budget=RetryBudget(budget=64, refill_per_second=8.0))
        sched_client = RestClusterClient(
            api.url, qps=qps,
            max_retries=8, retry_after_cap=0.5, retry_seed=seed + 1,
            retry_budget=RetryBudget(budget=64, refill_per_second=8.0))

        def arm_gate() -> None:
            code, resp = creator._request(
                "POST", "/debug/faults", spec_fn(seed), body_binary=False)
            if code != 200:
                raise RuntimeError(f"arming fault gate failed: {resp}")

        def gate_injected() -> int:
            code, snap = creator._request("GET", "/debug/faults")
            if code != 200:
                return 0
            return sum((snap.get("injected") or {}).values())

        # nodes land before the gate is armed (the chaos targets the
        # steady workload, not the cluster's bootstrap)
        node_objs = [
            MakeNode().name(f"n{i}").capacity(
                {"cpu": str(node_cpu), "memory": "64Gi", "pods": "110"}
            ).obj()
            for i in range(nodes)
        ]
        code, resp = creator._request(
            "POST", "/api/v1/nodes",
            {"kind": "NodeList", "items": node_objs}, charge=nodes)
        if code >= 400 or not _tolerable(resp):
            raise RuntimeError(f"node create failed: {resp}")

        sched = Scheduler.create(sched_client)
        sched.run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and sched.cache.node_count() < nodes:
            time.sleep(0.02)
        arm_gate()
        note(f"{nodes} nodes up, gate armed")

        kill_wave = kill_at_wave if kill_at_wave is not None \
            else rng.randrange(1, waves)
        per_wave = pods // waves
        created = 0
        for w in range(waves):
            count = per_wave if w < waves - 1 else pods - created
            items = [
                MakePod().name(f"c{w}-{i}").uid(f"u{w}-{i}")
                .req({"cpu": f"{pod_cpu_milli}m"}).obj()
                for i in range(count)
            ]
            # a wave must land even across the restart window: retry the
            # bulk POST (409-only failures: an earlier attempt applied)
            wave_deadline = time.monotonic() + 60
            while True:
                try:
                    code, resp = creator._request(
                        "POST", "/api/v1/namespaces/default/pods",
                        {"kind": "PodList", "items": items}, charge=count)
                    if code < 400 and _tolerable(resp):
                        break
                    err: object = resp
                except (OSError, RuntimeError) as e:
                    err = e
                if time.monotonic() > wave_deadline:
                    raise RuntimeError(f"wave {w} create failed: {err}")
                time.sleep(0.2)
            created += count
            if w == kill_wave:
                faults_injected += gate_injected()
                note(f"killing apiserver after wave {w}")
                api.kill()
                kills += 1
                time.sleep(rng.uniform(0.1, 0.5))
                api.restart()
                arm_gate()   # a fresh process: re-arm over the wire
                note("apiserver restarted from WAL")
            time.sleep(rng.uniform(0.0, 0.2))

        # quiescence: every created pod bound
        deadline = time.monotonic() + wait_timeout
        pods_live: List = []
        while time.monotonic() < deadline:
            try:
                pods_live = creator.list_pods()
            except (OSError, RuntimeError):
                time.sleep(0.5)
                continue
            if len(pods_live) >= created \
                    and all(p.spec.node_name for p in pods_live):
                break
            time.sleep(0.25)
        # the final reads run under faults still armed: a one-off
        # transport failure must not abort the verdict
        nodes_live = _retrying(creator.list_nodes)
        pods_live = _retrying(creator.list_pods)
        faults_injected += gate_injected()

        unbound = [p.metadata.name for p in pods_live
                   if not p.spec.node_name]
        invariants["all_bound"] = (
            len(pods_live) == created and not unbound)
        if not invariants["all_bound"]:
            failure = (f"{len(pods_live)}/{created} pods, "
                       f"unbound: {unbound[:8]}")
        node_by_name = {n.name: n for n in nodes_live}
        invariants["bound_nodes_exist"] = all(
            p.spec.node_name in node_by_name
            for p in pods_live if p.spec.node_name)
        used: Dict[str, int] = {}
        for p in pods_live:
            if p.spec.node_name:
                used[p.spec.node_name] = used.get(p.spec.node_name, 0) + sum(
                    int(c.resources.requests["cpu"].milli_value())
                    for c in p.spec.containers
                    if "cpu" in c.resources.requests)
        invariants["no_oversubscription"] = all(
            name in node_by_name and milli <= int(
                node_by_name[name].status.allocatable["cpu"].milli_value())
            for name, milli in used.items())

        # durability: the server's live assignment must equal a WAL
        # restore made in this process after a graceful stop
        live_assign = api.ask("assignments")
        sched.stop()
        sched = None
        api.stop(cleanup=False)
        restored = restore_store(api.wal_dir)
        got = {p.uid: p.spec.node_name for p in restored.list_pods()}
        invariants["wal_matches_live"] = got == live_assign
        if not invariants["wal_matches_live"] and not failure:
            diff = set(got) ^ set(live_assign) or {
                u for u in got if got[u] != live_assign.get(u)}
            failure = f"WAL restore diverged for {len(diff)} pods"

        invariants["no_rv_regression"] = (
            not creator.rv_regressions and not sched_client.rv_regressions)
        if not invariants["no_rv_regression"] and not failure:
            failure = (f"rv regressions: creator="
                       f"{creator.rv_regressions[:3]} scheduler="
                       f"{sched_client.rv_regressions[:3]}")
    finally:
        if sched is not None:
            sched.stop()
        api.stop(cleanup=True)

    retries = sum(v for _, _, v in fm.client_retries_total.collect()) \
        - retries_before
    degraded_seconds = fm.degraded_mode_seconds.get() - degraded_before
    return {
        "seed": seed,
        "profile": fault_profile,
        "ok": all(invariants.values()),
        "invariants": invariants,
        "failure": failure,
        "stats": {
            "pods": pods,
            "faults_injected": faults_injected,
            "client_retries": retries,
            "degraded_seconds": round(degraded_seconds, 3),
            "entered_degraded": degraded_seconds > 0,
            "kills": kills,
            "kill_wave": kill_wave,
            "server_starts": api.starts,
            "child_imports_torch": api.imports_torch,
            "wall_s": time.monotonic() - t0,
        },
    }
