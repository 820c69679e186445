"""Node-churn chaos: the node-death half of the chaos ring.

``chaos_rest`` attacks the wire (resets, pushback, an apiserver
SIGKILL); this harness attacks the nodes the batch path solves over
(the reference's ``test/e2e/chaosmonkey`` and the nodelifecycle
suites). While a workload streams in over REST, a seeded injector stops
node heartbeats, deletes nodes and later creates them again under the
same name (the flap re-registration path), flaps Ready conditions and
applies cordons and taints, at configurable rates. Meanwhile the real
control loops run beside the store, as in the reference's
controller-manager:

- ``NodeLifecycleController`` marks silent nodes NotReady, taints them
  ``node.kubernetes.io/unreachable`` and evicts their pods past the
  eviction grace;
- ``PodGCController`` collects the pods a node's deletion orphaned;
- the harness's ``PodRescuer`` plays the workload's owning controller:
  every evicted or orphaned workload pod is created again (a fresh uid,
  the same name), so it enters the scheduling queue again, and the
  eviction -> bound latency lands in ``pod_rescue_seconds``.

The scheduler under test runs the batch path over REST (the cluster
kernel on the card, ``device``): batches are solved against snapshots
that go stale mid-cycle by construction, which the commit-time
stale-node guards (``commit_target_flags`` -> ``commit_target_stale``)
and the session's node-epoch trigger exist for. With ``autoscale`` the
cluster autoscaler's what-ifs run on the scan kernel.

Invariants checked after quiescence (churn stopped, cluster healed):

- **no binds into the void**: every bound pod's node exists (the store
  accepts binds to nonexistent nodes, so one unguarded stale commit
  would leave a lasting violation), and no bind during the churn
  targeted a node long dead;
- **no lost pods**: every workload pod name ends bound (perhaps as a
  rescue generation) or terminally failed;
- **no oversubscription** on the surviving nodes;
- **cache == store**: the scheduler's cache converges to the store
  (the same nodes, the same placements, no assumed pod lingering).

The port's store takes batch watches only; the harness's watchers walk
each batch, so every event is still seen once and in order.
"""

from __future__ import annotations

import copy
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from kubernetes_tpu_torch.api.types import (
    FAILED,
    NO_SCHEDULE,
    SUCCEEDED,
    Taint,
    shallow_copy,
)
from kubernetes_tpu_torch.apiserver.store import ADDED, DELETED, MODIFIED
from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics

_logger = logging.getLogger(__name__)

# the injected (non-lifecycle) taint the injector applies and removes
CHAOS_TAINT = "chaos.kubernetes.io/injected"


# ---------------------------------------------------------------------------
# churn configuration


@dataclass
class ChurnSpec:
    """A seeded churn schedule. ``action_period`` is the mean pause
    between injector actions; the weights pick what happens. Every
    recovery delay is drawn from the same seeded rng, so a (seed, spec)
    pair replays the same action sequence."""

    action_period: float = 0.25
    kill_weight: float = 3.0      # delete the node (heartbeats stop), recreate later
    flap_weight: float = 3.0      # mute heartbeats past the grace, then resume
    cordon_weight: float = 2.0    # spec.unschedulable toggled
    taint_weight: float = 2.0     # a NoSchedule chaos taint, removed later
    recover_min: float = 0.6      # seconds before a kill, cordon or taint heals
    recover_max: float = 1.8
    flap_extra: float = 0.8       # mute time past the grace period
    max_dead_fraction: float = 0.34  # capacity guard: never kill or cordon more


CHURN_PROFILES: Dict[str, ChurnSpec] = {
    "mixed": ChurnSpec(),
    "killer": ChurnSpec(kill_weight=6.0, flap_weight=1.0,
                        cordon_weight=1.0, taint_weight=1.0),
    "flappy": ChurnSpec(kill_weight=1.0, flap_weight=6.0,
                        cordon_weight=1.0, taint_weight=1.0,
                        action_period=0.15),
    "gentle": ChurnSpec(action_period=0.6, max_dead_fraction=0.2),
}


def _each_event(on_event: Callable) -> Callable:
    """A batch watch callback that hands ``on_event`` each event of the
    batch, in order."""
    def on_events(events) -> None:
        for event in events:
            on_event(event)
    return on_events


# ---------------------------------------------------------------------------
# hollow heartbeats


class HeartbeatPump:
    """The hollow kubelets' lease renewals: one thread heartbeating
    every live node through the lifecycle controller, with a per-node
    mute set the injector flips to simulate a kubelet's death."""

    def __init__(self, nlc, node_names: List[str], interval: float):
        self._nlc = nlc
        self._interval = interval
        self._lock = threading.Lock()
        self._nodes: Set[str] = set(node_names)
        self._muted: Set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.beat_now()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hollow-heartbeats")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def mute(self, name: str) -> None:
        with self._lock:
            self._muted.add(name)

    def unmute(self, name: str) -> None:
        with self._lock:
            self._muted.discard(name)

    def add_node(self, name: str) -> None:
        """Adopt a node registered after the pump started (the
        autoscaler's capacity heartbeats like any hollow kubelet, or
        nodelifecycle taints it at the grace)."""
        with self._lock:
            self._nodes.add(name)

    def beat_now(self) -> None:
        with self._lock:
            live = self._nodes - self._muted
        for name in live:
            self._nlc.heartbeat(name)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat_now()


# ---------------------------------------------------------------------------
# the eviction -> requeue rescue pipeline


class PodRescuer:
    """The workload's owning controller: creates every deleted workload
    pod again (the same name, a fresh uid) so it enters the scheduling
    queue again, and measures eviction -> replacement bound into
    ``pod_rescue_seconds``. It watches the store directly (exact, in
    process) and creates over REST (the workload's own admission
    path)."""

    def __init__(self, store, client, name_prefix: str):
        self._store = store
        self._client = client
        self._prefix = name_prefix
        self._lock = threading.Lock()
        # name -> eviction time (monotonic); name -> rescue generation
        self._pending: Dict[str, float] = {}
        self._generation: Dict[str, int] = {}
        self._active = threading.Event()
        self._handle = None
        self.rescues: List[float] = []   # completed rescue latencies
        self.evictions_seen = 0
        self.recreate_failures = 0

    def start(self) -> None:
        self._active.set()
        self._handle = self._store.watch(_each_event(self._on_event))

    def stop(self) -> None:
        self._active.clear()
        if self._handle is not None:
            self._handle.stop()
            self._handle = None

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _on_event(self, event) -> None:
        if event.kind != "Pod" or not self._active.is_set():
            return
        pod = event.obj
        name = pod.metadata.name
        if not name.startswith(self._prefix):
            return
        if event.type == DELETED:
            if pod.status.phase in (SUCCEEDED, FAILED):
                return   # terminal pods stay dead
            with self._lock:
                already = name in self._pending
                if not already:
                    self._pending[name] = time.monotonic()
                    self._generation[name] = \
                        self._generation.get(name, 0) + 1
                self.evictions_seen += 1
            if not already:
                # the REST round trip runs outside the lock and off the
                # store's dispatch
                threading.Thread(
                    target=self._recreate, args=(pod, name),
                    daemon=True, name=f"rescue-{name}").start()
        elif event.type == MODIFIED and pod.spec.node_name:
            with self._lock:
                t0 = self._pending.pop(name, None)
            if t0 is not None:
                elapsed = time.monotonic() - t0
                fabric_metrics().pod_rescue_seconds.observe(elapsed)
                with self._lock:
                    self.rescues.append(elapsed)

    def _recreate(self, dead_pod, name: str) -> None:
        with self._lock:
            gen = self._generation.get(name, 1)
        fresh = shallow_copy(dead_pod)
        fresh.metadata = copy.copy(dead_pod.metadata)
        fresh.metadata.uid = f"{dead_pod.uid}-r{gen}"
        fresh.metadata.resource_version = ""
        fresh.spec = copy.copy(dead_pod.spec)
        fresh.spec.node_name = ""
        fresh.status = type(dead_pod.status)()
        deadline = time.monotonic() + 30
        while self._active.is_set():
            try:
                self._client.create_object("Pod", fresh)
                return
            except ValueError:
                return   # AlreadyExists: an earlier attempt landed
            except Exception:  # noqa: BLE001 — transient wire trouble
                if time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        with self._lock:
            self._pending.pop(name, None)
            self.recreate_failures += 1


class VoidBindWatch:
    """The headline invariant's tripwire during the churn: a bind event
    whose target node was deleted well before the bind arrived (beyond
    the commit -> watch delivery latency) and not created again is a
    bind into the void, which the commit-time stale-node guards exist to
    prevent. The bound-nodes-exist check after quiescence cannot see
    these for churn-killed nodes: quiescence creates them again under
    the same names before the check runs."""

    # the tolerance for the legitimate race: a bind committed while the
    # node lived, delivered just after it died
    GRACE_S = 0.25

    def __init__(self, store, name_prefix: str):
        self._store = store
        self._prefix = name_prefix
        self._lock = threading.Lock()
        self._dead_since: Dict[str, float] = {}
        self._handle = None
        self.violations: List[str] = []

    def start(self) -> None:
        self._handle = self._store.watch(_each_event(self._on_event))

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.stop()
            self._handle = None

    def _on_event(self, event) -> None:
        if event.kind == "Node":
            with self._lock:
                if event.type == DELETED:
                    self._dead_since.setdefault(
                        event.obj.name, time.monotonic())
                else:
                    self._dead_since.pop(event.obj.name, None)
            return
        if event.kind != "Pod" or event.type != MODIFIED:
            return
        pod = event.obj
        if not pod.metadata.name.startswith(self._prefix) or \
                not pod.spec.node_name:
            return
        if event.old_obj is not None and event.old_obj.spec.node_name:
            return   # not a bind transition
        with self._lock:
            died = self._dead_since.get(pod.spec.node_name)
            if died is not None and \
                    time.monotonic() - died > self.GRACE_S:
                self.violations.append(
                    f"{pod.metadata.name} bound to {pod.spec.node_name} "
                    f"{time.monotonic() - died:.2f}s after its deletion")


# ---------------------------------------------------------------------------
# the seeded injector


@dataclass
class _NodeState:
    template: object                 # the pristine Node to recreate from
    dead: bool = False
    cordoned: bool = False
    tainted: bool = False
    heal_at: float = field(default=0.0)
    heal: Optional[str] = None       # the pending recovery


class NodeChurnInjector:
    """The seeded node-churn loop. Each tick draws one action for one
    node from the seeded rng, applies it through the store (the injector
    plays the cloud provider and the kubelet process, not an API
    client), and schedules the matching recovery. ``restore_all`` heals
    the cluster for the quiesce phase."""

    def __init__(self, store, pump: HeartbeatPump, spec: ChurnSpec,
                 node_names: List[str], seed: int,
                 grace_period: float,
                 progress: Optional[Callable[[str], None]] = None):
        self._store = store
        self._pump = pump
        self._spec = spec
        self._rng = random.Random(seed)
        self._grace = grace_period
        self._progress = progress
        names = set(node_names)
        self._states: Dict[str, _NodeState] = {
            n.name: _NodeState(template=copy.deepcopy(n))
            for n in store.list_nodes() if n.name in names
        }
        self._flapping: Dict[str, float] = {}   # name -> unmute time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.actions: Dict[str, int] = {
            "kill": 0, "recreate": 0, "flap": 0, "cordon": 0,
            "uncordon": 0, "taint": 0, "untaint": 0,
        }

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-churn")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def restore_all(self) -> None:
        """Heal every injected condition (quiesce): recreate dead nodes,
        resume heartbeats, uncordon, strip the chaos taints. The
        lifecycle controller clears its own unreachable taints once the
        heartbeats resume."""
        for name, st in self._states.items():
            if st.dead:
                self._recreate(name, st)
            if st.cordoned:
                self._uncordon(name, st)
            if st.tainted:
                self._untaint(name, st)
            self._pump.unmute(name)
        self._flapping.clear()
        self._pump.beat_now()

    # -- the loop ------------------------------------------------------
    def _loop(self) -> None:
        spec = self._spec
        while not self._stop.wait(self._rng.uniform(
                0.5 * spec.action_period, 1.5 * spec.action_period)):
            try:
                now = time.monotonic()
                self._heal_due(now)
                self._unmute_due(now)
                self._act(now)
            except Exception:  # noqa: BLE001 — churn must not die mid-run
                _logger.exception("churn action failed")

    def _heal_due(self, now: float) -> None:
        for name, st in self._states.items():
            if st.heal is not None and now >= st.heal_at:
                heal, st.heal = st.heal, None
                if heal == "recreate":
                    self._recreate(name, st)
                elif heal == "uncordon":
                    self._uncordon(name, st)
                elif heal == "untaint":
                    self._untaint(name, st)

    def _unmute_due(self, now: float) -> None:
        for name, at in list(self._flapping.items()):
            if now >= at:
                del self._flapping[name]
                self._pump.unmute(name)

    def _disabled_count(self) -> int:
        return sum(1 for st in self._states.values()
                   if st.dead or st.cordoned) + len(self._flapping)

    def _act(self, now: float) -> None:
        spec = self._spec
        rng = self._rng
        weights = [("kill", spec.kill_weight), ("flap", spec.flap_weight),
                   ("cordon", spec.cordon_weight),
                   ("taint", spec.taint_weight)]
        total = sum(w for _, w in weights)
        if total <= 0:
            return
        pick = rng.uniform(0, total)
        action = weights[-1][0]
        for name, w in weights:
            if pick < w:
                action = name
                break
            pick -= w
        # the capacity guard: disabling actions respect the dead budget
        budget = int(spec.max_dead_fraction * len(self._states))
        candidates = [n for n, st in sorted(self._states.items())
                      if not st.dead and st.heal is None
                      and n not in self._flapping]
        if not candidates:
            return
        target = rng.choice(candidates)
        st = self._states[target]
        heal_delay = rng.uniform(spec.recover_min, spec.recover_max)
        if action == "kill" and self._disabled_count() < budget:
            self._pump.mute(target)
            self._store.delete_node(target)
            st.dead = True
            st.heal = "recreate"
            st.heal_at = now + heal_delay
            self.actions["kill"] += 1
            self._note(f"kill {target} (recreate in {heal_delay:.2f}s)")
        elif action == "flap" and self._disabled_count() < budget:
            self._pump.mute(target)
            self._flapping[target] = now + self._grace + spec.flap_extra
            self.actions["flap"] += 1
            self._note(f"flap {target}")
        elif action == "cordon" and not st.cordoned \
                and self._disabled_count() < budget:
            node = copy.deepcopy(self._store.get_node(target))
            if node is None:
                return
            node.spec.unschedulable = True
            self._store.update_node(node)
            st.cordoned = True
            st.heal = "uncordon"
            st.heal_at = now + heal_delay
            self.actions["cordon"] += 1
            self._note(f"cordon {target}")
        elif action == "taint" and not st.tainted:
            node = copy.deepcopy(self._store.get_node(target))
            if node is None:
                return
            node.spec.taints = list(node.spec.taints) + [
                Taint(CHAOS_TAINT, "x", NO_SCHEDULE)]
            self._store.update_node(node)
            st.tainted = True
            st.heal = "untaint"
            st.heal_at = now + heal_delay
            self.actions["taint"] += 1
            self._note(f"taint {target}")

    # -- recoveries ----------------------------------------------------
    def _recreate(self, name: str, st: _NodeState) -> None:
        node = copy.deepcopy(st.template)
        node.metadata.resource_version = ""
        try:
            self._store.add_node(node)
        except Exception:  # noqa: BLE001 — e.g. already added again
            pass
        st.dead = False
        self._pump.unmute(name)
        self.actions["recreate"] += 1
        self._note(f"recreate {name}")

    def _uncordon(self, name: str, st: _NodeState) -> None:
        node = self._store.get_node(name)
        if node is not None:
            node = copy.deepcopy(node)
            node.spec.unschedulable = False
            self._store.update_node(node)
        st.cordoned = False
        self.actions["uncordon"] += 1

    def _untaint(self, name: str, st: _NodeState) -> None:
        node = self._store.get_node(name)
        if node is not None:
            node = copy.deepcopy(node)
            node.spec.taints = [t for t in node.spec.taints
                                if t.key != CHAOS_TAINT]
            self._store.update_node(node)
        st.tainted = False
        self.actions["untaint"] += 1

    def _note(self, msg: str) -> None:
        if self._progress:
            self._progress(f"churn: {msg}")


# ---------------------------------------------------------------------------
# the seeded chaos run


def _cache_matches_store(sched, store) -> Optional[str]:
    """None when the scheduler's cache equals the store; else a short
    description of the divergence (polled until the quiesce timeout)."""
    dump = sched.cache.dump()
    if dump["assumed_pods"]:
        return f"assumed pods linger: {sorted(dump['assumed_pods'])[:4]}"
    cache_nodes = {n for n, info in dump["nodes"].items()
                   if info.node is not None}
    store_nodes = {n.name for n in store.list_nodes()}
    if cache_nodes != store_nodes:
        return (f"node sets differ: cache-only="
                f"{sorted(cache_nodes - store_nodes)[:4]} store-only="
                f"{sorted(store_nodes - cache_nodes)[:4]}")
    cache_placed = {}
    for info in dump["nodes"].values():
        for pi in info.pods:
            pod = pi.pod
            cache_placed[f"{pod.namespace}/{pod.name}"] = \
                pod.spec.node_name
    store_placed = {
        f"{p.namespace}/{p.name}": p.spec.node_name
        for p in store.list_pods() if p.spec.node_name
        and p.status.phase not in (SUCCEEDED, FAILED)
    }
    if cache_placed != store_placed:
        diff = set(cache_placed.items()) ^ set(store_placed.items())
        return f"{len(diff)} placement(s) differ: {sorted(diff)[:4]}"
    return None


def _poll(fn: Callable[[], Optional[str]], timeout: float) -> Optional[str]:
    """``fn()`` every 0.25 s until it returns None or ``timeout`` runs
    out; the last answer."""
    deadline = time.monotonic() + timeout
    why = "never polled"
    while time.monotonic() < deadline:
        why = fn()
        if why is None:
            break
        time.sleep(0.25)
    return why


def run_chaos_nodes(
    seed: int,
    nodes: int = 16,
    pods: int = 96,
    node_cpu: int = 16,
    pod_cpu_milli: int = 500,
    waves: int = 6,
    churn_profile: str = "mixed",
    max_batch: int = 64,
    grace_period: float = 1.0,
    eviction_grace: float = 0.5,
    heartbeat_interval: float = 0.2,
    wait_timeout: float = 120.0,
    autoscale: bool = False,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """One seeded node-churn run; returns ``{"ok", "invariants",
    "failure", "stats"}``. The workload streams in over REST while the
    injector churns nodes; quiescence heals the cluster, and the
    invariants are checked against the store.

    ``autoscale=True`` runs the cluster autoscaler beside the control
    plane: when churn-killed capacity leaves workload pods
    unschedulable, the what-if solve buys replacement nodes from an
    ``ng-chaos`` group (scale-down stays off: removing nodes mid-churn
    is the injector's job). The invariants hold unchanged.

    The batch path and the what-ifs run on ``device``: the card unless
    "cpu" is passed (raises without one)."""
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.config.feature_gates import FeatureGates
    from kubernetes_tpu_torch.controllers.nodelifecycle import (
        UNREACHABLE_TAINT,
        NodeLifecycleController,
    )
    from kubernetes_tpu_torch.controllers.podgc import PodGCController
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.harness.burst import make_burst_pods
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
    from kubernetes_tpu_torch.testing import MakeNode

    dev = resolve_device(device)

    def note(msg: str) -> None:
        if progress:
            progress(f"chaos_nodes[{seed}/{churn_profile}]: {msg}")

    rng = random.Random(seed)
    spec = CHURN_PROFILES[churn_profile]
    fm = fabric_metrics()

    def churn_counters() -> Dict[str, float]:
        return {
            "evictions": sum(
                v for _, _, v in fm.node_evictions_total.collect()),
            "stale_rejected": sum(
                v for _, _, v in fm.stale_binds_rejected_total.collect()),
        }

    before = churn_counters()
    t0 = time.monotonic()

    store = ClusterStore()
    node_names = [f"cn{i}" for i in range(nodes)]
    for name in node_names:
        store.add_node(
            MakeNode().name(name).capacity(
                {"cpu": str(node_cpu), "memory": "64Gi", "pods": "110"}
            ).obj())

    server = APIServer(store=store).start()
    sched = bs = None
    pump = injector = rescuer = nlc = gc = void_watch = None
    ca = None
    ca_node_watch = None
    factory = None
    invariants: Dict[str, bool] = {}
    failure = ""
    try:
        creator = RestClusterClient(server.url, watch_kinds=())
        sched_client = RestClusterClient(server.url, retry_seed=seed)

        # the control plane beside the store (the controller-manager)
        factory = SharedInformerFactory(store)
        nlc = NodeLifecycleController(store, factory)
        nlc.grace_period = grace_period
        nlc.eviction_grace = eviction_grace
        nlc.monitor_interval = min(0.05, grace_period / 4)
        gc = PodGCController(store, factory)
        gc.RESYNC_SECONDS = 0.25
        if autoscale:
            from kubernetes_tpu_torch.autoscaler.controller import (
                ClusterAutoscaler,
            )
            from kubernetes_tpu_torch.autoscaler.nodegroups import (
                NodeGroup,
                NodeGroupRegistry,
            )

            registry = NodeGroupRegistry()
            registry.add(NodeGroup(
                "ng-chaos", cpu=str(node_cpu), memory="64Gi",
                min_size=0, max_size=nodes, boot_latency=0.1,
            ))
            ca = ClusterAutoscaler(store, factory, registry=registry,
                                   device=dev)
            ca.RESYNC_SECONDS = 0.1
            ca.scale_up_cooldown = 0.75
            ca.scale_down_enabled = False
        factory.start()
        factory.wait_for_cache_sync()
        nlc.run()
        gc.run()

        pump = HeartbeatPump(nlc, node_names, heartbeat_interval)
        pump.start()
        if ca is not None:
            # provisioned nodes heartbeat like any hollow kubelet
            def adopt_autoscaled(event) -> None:
                if event.kind == "Node" and event.type == ADDED \
                        and event.obj.name.startswith("ng-chaos-"):
                    pump.add_node(event.obj.name)

            ca_node_watch = store.watch(_each_event(adopt_autoscaled))

        sched = Scheduler.create(
            sched_client,
            feature_gates=FeatureGates({"TPUBatchScheduler": True}))
        bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev)
        if ca is not None:
            ca.queue_introspect = sched.queue
            ca.run()
        sched.run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                sched.cache.node_count() < nodes:
            time.sleep(0.02)

        rescuer = PodRescuer(store, creator, name_prefix="cp-")
        rescuer.start()
        void_watch = VoidBindWatch(store, name_prefix="cp-")
        void_watch.start()
        injector = NodeChurnInjector(store, pump, spec, node_names,
                                     seed, grace_period, progress=note)
        injector.start()
        note(f"{nodes} nodes up, churn running")

        # the workload, over REST, interleaved with the churn: waves of
        # the shared pending-burst generator
        per_wave = pods // waves
        created = 0
        for w in range(waves):
            count = per_wave if w < waves - 1 else pods - created
            items = make_burst_pods(
                count, cpu_milli=pod_cpu_milli,
                name_prefix=f"cp-{w}-", uid_prefix=f"cu{w}-")
            made = creator.create_objects_bulk("Pod", items)
            if made != count:
                raise RuntimeError(
                    f"wave {w} create failed: {made}/{count} created")
            created += count
            time.sleep(rng.uniform(0.1, 0.4))

        # let the churn keep biting while the tail schedules
        time.sleep(2 * grace_period)

        # quiesce: stop the churn, heal the cluster, let the lifecycle
        # controller clear its unreachable taints, then wait for every
        # workload pod to settle
        injector.stop()
        injector.restore_all()
        note("churn stopped, cluster healing")
        expected = [f"cp-{w}-{i}"
                    for w in range(waves)
                    for i in range(per_wave if w < waves - 1
                                   else pods - (waves - 1) * per_wave)]

        def settled() -> Optional[str]:
            live = {p.metadata.name: p for p in store.list_pods()
                    if p.metadata.name.startswith("cp-")}
            missing = [n for n in expected if n not in live]
            if missing:
                return f"{len(missing)} pods missing ({missing[:4]})"
            unbound = [n for n, p in live.items()
                       if not p.spec.node_name
                       and p.status.phase not in (SUCCEEDED, FAILED)]
            if unbound:
                return f"{len(unbound)} pods unbound ({unbound[:4]})"
            if rescuer.pending():
                return f"{rescuer.pending()} rescues in flight"
            return None

        why = _poll(settled, wait_timeout)
        invariants["all_bound_or_terminal"] = why is None
        if why is not None:
            failure = why

        # taints healed: no unreachable or chaos taint left on a node
        leftover = _poll(lambda: "tainted" if any(
            t.key in (UNREACHABLE_TAINT, CHAOS_TAINT)
            for n in store.list_nodes() for t in n.spec.taints) else None,
            30.0)
        invariants["taints_healed"] = leftover is None

        # no binds into the void: every bound pod's node exists at
        # quiesce, and no bind targeted a long-dead node during the
        # churn (the final check alone is vacuous for churn-killed
        # nodes: quiescence creates them again under their names)
        live_nodes = {n.name for n in store.list_nodes()}
        pods_live = [p for p in store.list_pods()
                     if p.metadata.name.startswith("cp-")]
        voided = [p.metadata.name for p in pods_live
                  if p.spec.node_name and p.spec.node_name not in live_nodes]
        voided.extend(void_watch.violations)
        invariants["no_binds_to_dead_nodes"] = not voided
        if voided and not failure:
            failure = f"bound into the void: {voided[:6]}"

        # no oversubscription on the surviving nodes
        used: Dict[str, int] = {}
        for p in pods_live:
            if p.spec.node_name and p.status.phase not in (SUCCEEDED,
                                                           FAILED):
                used[p.spec.node_name] = \
                    used.get(p.spec.node_name, 0) + pod_cpu_milli
        node_by_name = {n.name: n for n in store.list_nodes()}
        invariants["no_oversubscription"] = all(
            name in node_by_name
            and milli <= int(node_by_name[name]
                             .status.allocatable["cpu"].milli_value())
            for name, milli in used.items())

        # cache == store convergence
        diverged = _poll(lambda: _cache_matches_store(sched, store), 30.0)
        invariants["cache_converged"] = diverged is None
        if diverged is not None and not failure:
            failure = f"cache diverged: {diverged}"
    finally:
        for component in (injector, pump, rescuer, void_watch, nlc, gc,
                          ca, ca_node_watch):
            if component is not None:
                try:
                    component.stop()
                except Exception:  # noqa: BLE001 — teardown best effort
                    pass
        if factory is not None:
            factory.stop()
        if sched is not None:
            sched.stop()
        server.shutdown_server()

    after = churn_counters()
    rescues = sorted(rescuer.rescues) if rescuer is not None else []

    def pct(q: float) -> float:
        if not rescues:
            return 0.0
        return rescues[min(len(rescues) - 1, int(q * len(rescues)))]

    return {
        "seed": seed,
        "profile": churn_profile,
        "ok": all(invariants.values()),
        "invariants": invariants,
        "failure": failure,
        "stats": {
            "pods": pods,
            "churn_actions": dict(injector.actions)
            if injector is not None else {},
            "evictions": after["evictions"] - before["evictions"],
            "stale_binds_rejected": after["stale_rejected"]
            - before["stale_rejected"],
            "rescues": len(rescues),
            "rescue_p50_s": round(pct(0.50), 3),
            "rescue_p99_s": round(pct(0.99), 3),
            "recreate_failures": rescuer.recreate_failures
            if rescuer is not None else 0,
            "session_rebuilds": bs.session.rebuilds,
            "batch_solves": bs.session.backend.solves,
            "autoscaler_scaleups": ca.scale_up_events
            if ca is not None else 0,
            "autoscaler_nodes_added": ca.provisioner.provisioned_total
            if ca is not None else 0,
            "whatif_solves": ca.whatif_solves if ca is not None else 0,
            "device": str(dev) if dev is not None else None,
            "wall_s": time.monotonic() - t0,
        },
    }
