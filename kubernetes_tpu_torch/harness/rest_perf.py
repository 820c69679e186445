"""scheduler_perf over the REST fabric: the row where every byte crosses
the wire, as the reference's scheduler_perf runs it (an apiserver, and
every client through REST at QPS/Burst 5000). The store-direct harness
(``perf.py``) leaves that cost out; this one includes it:

- **apiserver process**: a ClusterStore with the WAL behind it (the
  etcd analog) served by ``APIServer``: bearer-token authentication,
  the RBAC bootstrap policy, admission, the watch cache and API
  Priority and Fairness all live.
- **creator process**: builds the workload's objects from the same op
  list and POSTs them through ``RestClusterClient`` as bulk {Kind}List
  bodies, round robin over ``n_creator_clients`` clients, each with its
  own bucket charged per object (the reference's per-client 5,000 QPS,
  whatever the batching).
- **scheduler (this process, which owns the card)**: fed by list and
  watch over chunked HTTP (server-coalesced binary chunks), binding
  through bulk BindingList requests shipped on the binding pool, so
  cycles never wait on the bind round trip. "Scheduled" Events ride a
  client and bucket of their own, as the reference's events client
  does.

The children are spawned and import only the fabric's modules and
``harness.workloads`` (``harness/__init__`` exports the rest lazily):
no torch, no CUDA context beside the scheduler's. Each also gets its
own interpreter lock, as each reference component is its own process.

Throughput is counted from the scheduler's commit metric (successful
REST binds); at the end the apiserver process reports its own bound-pod
count and WAL length, and the two counts must agree: the measured
number is store truth. The apiserver's ``/metrics`` are folded into
this process (``metrics.federation``), and its ``/debug/trace`` ring is
merged with this one's for the critical path.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.harness.workloads import make_workload

SCHEDULER_TOKEN = "rest-perf-scheduler-token"
CREATOR_TOKEN = "rest-perf-creator-token"
# seconds a spawned child may take to come up (its imports included)
CHILD_START_S = 120.0


# ---------------------------------------------------------------------------
# child mains (spawned; they import no torch, see harness/__init__)


@contextlib.contextmanager
def _main_hidden():
    """While a child is spawned: a spawned child imports the parent's
    ``__main__`` script again (as ``__mp_main__``), and with it whatever
    the script imports (torch, a CUDA context). The children's targets
    live in this module, so hide the script from the spawn."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    saved = {k: main.__dict__[k] for k in ("__file__", "__spec__")
             if k in main.__dict__}
    main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__dict__.update(saved)


def grant_tenants(store, role: str, extra_tokens: Dict[str, str],
                  rules) -> None:
    """A ClusterRole ``role`` of ``rules`` ((verbs, resources) pairs)
    bound to every user of ``extra_tokens``: authenticated identities
    outside the control plane and ``system:masters``, so APF routes each
    to the workload level as a flow of its own."""
    from kubernetes_tpu_torch.api.types import (
        ClusterRole,
        ClusterRoleBinding,
        ObjectMeta,
        PolicyRule,
        RBACSubject,
        RoleRef,
    )

    store.add_cluster_role(ClusterRole(
        metadata=ObjectMeta(name=role),
        rules=[PolicyRule(verbs=list(verbs), resources=list(resources))
               for verbs, resources in rules]))
    store.add_cluster_role_binding(ClusterRoleBinding(
        metadata=ObjectMeta(name=role + "s"),
        subjects=[RBACSubject(kind="User", name=u)
                  for u in extra_tokens.values()],
        role_ref=RoleRef(kind="ClusterRole", name=role)))


# what the noisy-tenant aggressors may do: enough for list storms, watch
# herds and bulk ConfigMap abuse, nothing privileged
QOS_TENANT_RULES = ((("get", "list", "watch"), ("pods", "nodes", "services")),
                    (("get", "list", "watch", "create"), ("configmaps",)))


def _apiserver_main(conn, wal_dir: Optional[str],
                    extra_tokens: Optional[Dict[str, str]] = None) -> None:
    from kubernetes_tpu_torch.apiserver.rbac import provision_bootstrap_policy
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import MODIFIED, ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    store = ClusterStore()
    # the asynchronous WAL writer: serialization rides a background
    # thread instead of every request's critical section (etcd pipelines
    # its log appends the same way)
    wal = attach_wal(store, wal_dir, snapshot_every=200_000,
                     async_serialize=True) \
        if wal_dir else None
    # create to bind on this process's clock: each pod's creation
    # commit (creationTimestamp) to its bind commit, as a user of the
    # deployable system sees it (watch delivery to the scheduler and
    # the bind's round trip included)
    binds: List[tuple] = []

    def note_binds(events) -> None:
        for e in events:
            if e.type == MODIFIED and e.kind == "Pod" and \
                    e.old_obj is not None and e.obj.spec.node_name and \
                    not e.old_obj.spec.node_name:
                created = e.obj.metadata.creation_timestamp
                binds.append((created, (e.ts or time.time()) - created))

    bind_watch = store.watch(note_binds)
    authz = provision_bootstrap_policy(store)
    authz.add_user_to_group("perf-creator", "system:masters")
    tokens = {SCHEDULER_TOKEN: "system:kube-scheduler",
              CREATOR_TOKEN: "perf-creator"}
    if extra_tokens:
        # the noisy-tenant row's aggressors (``harness/qos.py``)
        tokens.update(extra_tokens)
        grant_tenants(store, "qos-tenant", extra_tokens, QOS_TENANT_RULES)
    server = APIServer(store=store, authorizer=authz, tokens=tokens).start()
    conn.send(server.url)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if isinstance(msg, tuple) and msg[0] == "counts":
            since = msg[1]   # pods created from then on are measured
            pods = store.list_pods()
            if wal is not None:
                wal.drain()   # the async writer: count settled lines
            conn.send({
                "pods_total": len(pods),
                "pods_bound": sum(1 for p in pods if p.spec.node_name),
                "wal_entries": _wal_lines(wal_dir),
                "overcommitted_nodes": _overcommitted_nodes(store),
                "modules": sorted(sys.modules),
                "create_to_bind_s": [lat for created, lat in list(binds)
                                     if created >= since],
            })
    bind_watch.stop()
    server.shutdown_server()
    if wal is not None:
        wal.close()
    conn.send("stopped")


def _wal_lines(wal_dir: Optional[str]) -> int:
    if not wal_dir:
        return 0
    try:
        with open(os.path.join(wal_dir, "wal.jsonl"), "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def _overcommitted_nodes(store) -> List[str]:
    """Nodes whose bound pods request more of some resource, pod slots
    included, than the node allocates: the store's own check that no
    assume was lost between the scheduler's solves and the binds."""
    from kubernetes_tpu_torch.scheduler.types import (
        Resource,
        compute_pod_resource_request,
    )

    used = {}
    for pod in store.list_pods():
        if pod.spec.node_name:
            r = used.setdefault(pod.spec.node_name, Resource())
            r.add(compute_pod_resource_request(pod))
            r.allowed_pod_number += 1
    out = []
    for node in store.list_nodes():
        u = used.get(node.name)
        if u is None:
            continue
        a = Resource.from_resource_list(node.status.allocatable)
        if u.milli_cpu > a.milli_cpu or u.memory > a.memory or \
                u.ephemeral_storage > a.ephemeral_storage or \
                u.allowed_pod_number > a.allowed_pod_number or \
                any(v > a.scalar_resources.get(k, 0)
                    for k, v in u.scalar_resources.items()):
            out.append(node.name)
    return out


def _real_failures(resp) -> list:
    """Bulk-create failures that are not 409s: a create applied before a
    dropped keep-alive comes back AlreadyExists on the client's retry,
    and for a creator whose goal is "these objects exist" that is
    success."""
    return [f for f in (resp.get("failures") or ())
            if f.get("code") != 409]


def _creator_main(conn, url: str, name: str, nodes: int, init_pods: int,
                  measure_pods: int, qps: Optional[float],
                  n_clients: int) -> None:
    """Runs create ops on demand: the op's index comes down the pipe,
    ("done", index, count) or ("error", index, message) goes back."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.harness.burst import stream_arrivals

    clients = [RestClusterClient(url, token=CREATOR_TOKEN, qps=qps)
               for _ in range(max(1, n_clients))]
    ops = make_workload(name, nodes, init_pods, measure_pods)
    chunk = 512
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "modules":
            conn.send(sorted(sys.modules))
            continue
        op_idx = msg
        op = ops[op_idx]
        if op["opcode"] == "createNodes":
            objs = [Node.from_dict(op["nodeTemplate"](i))
                    for i in range(op["count"])]
            for lo in range(0, len(objs), chunk):
                part = objs[lo:lo + chunk]
                code, resp = clients[0]._request(
                    "POST", "/api/v1/nodes",
                    {"kind": "NodeList", "items": part}, charge=len(part))
                if code >= 400 or _real_failures(resp):
                    conn.send(("error", op_idx, str(resp)[:500]))
                    break
            else:
                conn.send(("done", op_idx, len(objs)))
            continue
        if op["opcode"] == "createPods":
            template = op["podTemplate"]
            offset = op.get("offset", 0)
            rotation = [0]

            def send(items):
                client = clients[rotation[0] % len(clients)]
                rotation[0] += 1
                code, resp = client._request(
                    "POST", "/api/v1/namespaces/default/pods",
                    {"kind": "PodList", "items": items}, charge=len(items))
                if code >= 400 or _real_failures(resp):
                    raise RuntimeError(str(resp)[:500])

            try:
                # the open-loop injection helper at an infinite rate:
                # pods built lazily a chunk at a time, clients rotated
                # a chunk at a time
                sent = stream_arrivals(
                    ((0.0, Pod.from_dict(template(offset + i)))
                     for i in range(op["count"])),
                    send, chunk=chunk, time_scale=0.0)
                conn.send(("done", op_idx, sent))
            except RuntimeError as e:
                conn.send(("error", op_idx, str(e)))
            continue
        conn.send(("done", op_idx, 0))
    for client in clients:
        client.close()
    conn.send("stopped")


# ---------------------------------------------------------------------------
# parent (scheduler and card)


def run_workload_rest(
    name: str,
    nodes: int,
    measure_pods: int,
    init_pods: int = 0,
    max_batch: int = 4096,
    qps: Optional[float] = 5000.0,
    n_creator_clients: int = 2,
    wait_timeout: float = 1200.0,
    wal: bool = True,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
    result_hook: Optional[Callable[[object, object], None]] = None,
    extra_tokens: Optional[Dict[str, str]] = None,
    on_measure_start: Optional[Callable[[str], Callable[[], None]]] = None,
):
    """Run one workload with every object crossing the REST fabric, the
    scheduler's solves on ``device`` (the CUDA card unless "cpu" is
    passed; raises when no card is available). Returns a
    ``BenchmarkResult`` whose ``metrics`` carry the apiserver process's
    own final counts beside the scheduler's (``server_pods_bound``,
    ``scheduler_bound``, ``wal_entries``), the APF snapshot, the
    federation's instances, the watch-delivery percentiles and the
    ``torch`` check of the children's modules (``children_import_torch``).

    ``extra_tokens`` (token -> user) adds identities the apiserver
    grants the ``qos-tenant`` role; ``on_measure_start(url)`` runs as the
    measurement starts and returns a stopper, called once the measured
    pods are bound (companion load: the noisy-tenant row's aggressors);
    ``result_hook(sched, bs)`` runs before the children stop;
    ``progress`` gets a line at each step."""
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.config.feature_gates import FeatureGates
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.harness.perf import (
        BenchmarkResult,
        ThroughputCollector,
        _percentiles,
        attach_slo_baseline,
        collect_critical_path,
        collect_freshness,
        reset_sli_window,
    )
    from kubernetes_tpu_torch.metrics import default_registry
    from kubernetes_tpu_torch.metrics.apf_metrics import apf_metrics
    from kubernetes_tpu_torch.metrics.federation import metrics_federation
    from kubernetes_tpu_torch.metrics.freshness_metrics import (
        freshness_metrics,
    )
    from kubernetes_tpu_torch.observability.devprof import get_devprof
    from kubernetes_tpu_torch.observability.slo import get_slo_engine
    from kubernetes_tpu_torch.observability.tracer import get_tracer
    from kubernetes_tpu_torch.ops.encode import is_host_only
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    dev = resolve_device(device)
    tune_for_throughput()
    get_tracer().clear()
    get_devprof().reset(workload=f"{name}/rest")
    reset_sli_window()
    ctx = mp.get_context("spawn")
    wal_dir = tempfile.mkdtemp(prefix="ktpu-wal-") if wal else None

    api_conn, api_child = ctx.Pipe()
    api_proc = ctx.Process(target=_apiserver_main,
                           args=(api_child, wal_dir, extra_tokens),
                           daemon=True)
    with _main_hidden():
        api_proc.start()
    if not api_conn.poll(CHILD_START_S):
        api_proc.terminate()
        raise RuntimeError("the apiserver child did not start")
    url = api_conn.recv()
    cre_conn, cre_child = ctx.Pipe()
    cre_proc = ctx.Process(
        target=_creator_main,
        args=(cre_child, url, name, nodes, init_pods, measure_pods, qps,
              n_creator_clients),
        daemon=True)
    with _main_hidden():
        cre_proc.start()

    def teardown_children() -> None:
        """Always runs: a failed row must not leak an apiserver holding a
        30,000-pod store, or its WAL directory."""
        for conn in (cre_conn, api_conn):
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for conn, proc in ((cre_conn, cre_proc), (api_conn, api_proc)):
            try:
                if conn.poll(5.0):
                    conn.recv()
            except (EOFError, OSError):
                pass
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        if wal_dir:
            import shutil

            shutil.rmtree(wal_dir, ignore_errors=True)

    client = RestClusterClient(url, token=SCHEDULER_TOKEN, qps=qps)
    # "Scheduled" Events on their own client and bucket: sharing the bind
    # client's would charge a token a bound pod against the bind budget
    event_client = RestClusterClient(url, token=SCHEDULER_TOKEN, qps=qps)
    try:
        sched = Scheduler.create(
            client, provider="GangSchedulingProvider",
            feature_gates=FeatureGates({"TPUBatchScheduler": True}),
            event_client=event_client)
        bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev)
        attach_slo_baseline(sched)
    except BaseException:
        client.close()
        event_client.close()
        teardown_children()
        raise
    slo_engine = get_slo_engine()

    def bound_count() -> int:
        return sched.metrics.e2e_scheduling_duration.count("scheduled")

    def run_op(op_idx: int) -> int:
        cre_conn.send(op_idx)
        # pump the scheduler while the creator streams objects in
        while not cre_conn.poll(0.0):
            if not (cre_proc.is_alive() and api_proc.is_alive()):
                raise RuntimeError(f"a child process died during op "
                                   f"{op_idx}")
            bs.run_batch(pop_timeout=0.01)
        status, _idx, n = cre_conn.recv()
        if status == "error":
            raise RuntimeError(f"creator op {op_idx} failed: {n}")
        return n

    def pump_until(target: int, deadline: float) -> None:
        while time.monotonic() < deadline:
            sched.queue.flush_backoff_completed()
            progressed = bs.run_batch(pop_timeout=0.01)
            if bound_count() >= target:
                return
            if not progressed:
                time.sleep(0.002)
        raise TimeoutError(f"workload {name}: bound {bound_count()}/"
                           f"{target} before the deadline")

    collector = None
    measure_start = 0.0
    # measure_start on the wall clock the apiserver stamps creations with
    measure_wall = 0.0
    expected_bound = 0
    created_pods = 0
    federation_instances: List[str] = []
    apf_snapshot = None
    stop_companions: Optional[Callable[[], None]] = None
    critpath: dict = {}
    ops = make_workload(name, nodes, init_pods, measure_pods)
    try:
        sched.start()
        for i, op in enumerate(ops):
            opcode = op["opcode"]
            if opcode == "createNodes":
                run_op(i)
                # the cache learns nodes from the watch; solving before
                # they land would decline the first batches
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and \
                        sched.cache.node_count() < op["count"]:
                    time.sleep(0.02)
                if progress:
                    progress(f"{name}/rest: {sched.cache.node_count()} "
                             f"nodes")
            elif opcode == "createPods":
                collect = op.get("collectMetrics", False)
                if collect and collector is None:
                    template = op["podTemplate"]
                    offset = op.get("offset", 0)
                    samples = [Pod.from_dict(template(offset + j))
                               for j in range(min(200, op["count"]))]
                    samples = [p for p in samples
                               if not is_host_only(p, client)]
                    warm = bs.warmup(samples) if samples else 0.0
                    if progress and warm > 0.05:
                        progress(f"{name}/rest: solver warmup {warm:.1f}s")
                    if on_measure_start is not None:
                        # companion load runs through the whole measured
                        # window, from its first pod
                        stop_companions = on_measure_start(url)
                    collector = ThroughputCollector(count_fn=bound_count)
                    measure_start = time.monotonic()
                    measure_wall = time.time()
                    collector.start()
                n = run_op(i)
                created_pods += n
                if progress:
                    progress(f"{name}/rest: {created_pods} pods created")
                if not op.get("skipWaitToCompletion", False):
                    expected_bound += n
                    pump_until(expected_bound,
                               time.monotonic() + wait_timeout)
            elif opcode == "barrier":
                pump_until(expected_bound, time.monotonic() + wait_timeout)
            else:
                raise ValueError(f"opcode {opcode!r} is not run over REST")
        bs.flush()
        if not sched.wait_for_inflight_bindings(timeout=30.0):
            raise TimeoutError(f"workload {name}: binds still in flight")
        duration = time.monotonic() - measure_start if measure_start \
            else 0.0
        if stop_companions is not None:
            stop, stop_companions = stop_companions, None
            stop()
        # the apiserver's series folded into this process's same-name
        # counters (the APF counters the rest_availability SLO reads
        # among them), this process mirrored beside it
        apfm = apf_metrics()
        fed = metrics_federation()
        fed.forget_instance("apiserver")
        fed.forget_instance("scheduler")
        fed.scrape(url, instance="apiserver", token=SCHEDULER_TOKEN,
                   fold=True)
        fed.absorb_registry(default_registry(), instance="scheduler")
        federation_instances = sorted(fed.instances())
        code, snap = client._request("GET", "/debug/apf")
        if code == 200 and isinstance(snap, dict):
            apf_snapshot = apfm.last_snapshot = snap
        # the apiserver's ring merged with this one's, skew-corrected
        critpath, fleet_doc = collect_critical_path(
            remote=[("apiserver", url)], token=SCHEDULER_TOKEN)
        trace_out = os.environ.get("KTPU_FLEET_TRACE_OUT")
        if trace_out and fleet_doc is not None:
            with open(trace_out, "w") as f:
                json.dump(fleet_doc, f)
        if slo_engine.enabled:
            slo_engine.tick()
        if result_hook is not None:
            result_hook(sched, bs)
        api_conn.send(("counts", measure_wall))
        if not api_conn.poll(60.0):
            raise RuntimeError("the apiserver child did not report")
        server_counts = api_conn.recv()
        cre_conn.send("modules")
        if not cre_conn.poll(60.0):
            raise RuntimeError("the creator child did not report")
        creator_modules = cre_conn.recv()
    finally:
        if stop_companions is not None:
            stop_companions()
        if collector is not None:
            collector.stop()
        sched.stop()
        client.close()
        event_client.close()
        teardown_children()

    measured = sum(op["count"] for op in ops
                   if op["opcode"] == "createPods"
                   and op.get("collectMetrics"))
    if server_counts["pods_bound"] < expected_bound:
        raise RuntimeError(
            f"store truth disagrees: the apiserver holds "
            f"{server_counts['pods_bound']} bound pods, expected "
            f"{expected_bound}")
    e2e = sched.metrics.e2e_scheduling_duration
    delivery = freshness_metrics().watch_delivery_seconds
    metrics = {
        "Perc50": e2e.quantile(0.50, "scheduled") * 1000,
        "Perc90": e2e.quantile(0.90, "scheduled") * 1000,
        "Perc99": e2e.quantile(0.99, "scheduled") * 1000,
        "server_pods_bound": server_counts["pods_bound"],
        "server_pods_total": server_counts["pods_total"],
        "wal_entries": server_counts["wal_entries"],
        "overcommitted_nodes": server_counts["overcommitted_nodes"],
        "scheduler_bound": bound_count(),
        "apf": apf_snapshot,
        "federation_instances": federation_instances,
        "watch_delivery_p50_ms": delivery.quantile(0.50, "Pod") * 1000,
        "watch_delivery_p99_ms": delivery.quantile(0.99, "Pod") * 1000,
        "watch_delivery_events": delivery.count("Pod"),
        # create to bind (ms) over the measured pods, on the apiserver's
        # clock; Perc50-99 above start at the scheduler's solve
        "create_to_bind": {
            **_percentiles(server_counts["create_to_bind_s"], 1000.0),
            "n": len(server_counts["create_to_bind_s"])},
        "children_import_torch": ("torch" in server_counts["modules"]
                                  or "torch" in creator_modules),
        "rv_regressions": len(client.rv_regressions),
    }
    dp = get_devprof()
    telemetry = dp.summary() if dp.enabled else {}
    session = bs.session
    return BenchmarkResult(
        name=f"{name}/rest",
        device=str(dev),
        total_pods=created_pods,
        measured_pods=measured,
        duration_seconds=duration,
        pods_per_second=(measured / duration) if duration > 0 else 0.0,
        throughput=collector.summary() if collector else {},
        metrics=metrics,
        latency=_percentiles(sched.pending_latencies, 1000.0),
        solves=session.backend.solves,
        rebuilds=session.rebuilds,
        state_only_rebuilds=session.state_only_rebuilds,
        seconds={**session.seconds, "commit": bs.seconds_commit},
        pipeline=bs.pipeline_enabled,
        mirror=session.mirror is not None,
        host_paths=dict(bs.seconds),
        binding=dict(sched.binding_stats),
        telemetry=telemetry,
        critical_path=critpath,
        freshness=collect_freshness(telemetry),
        chunk=bs._chunk,
        warmed_pads=sorted(bs._warmed_pads),
    )

