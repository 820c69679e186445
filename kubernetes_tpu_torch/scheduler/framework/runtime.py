"""The framework runtime: one instance per scheduler profile, holding the
plugins of each extension point and running them in order.

The framework is the plugins' handle: ``snapshot()``, ``client``,
``pod_nominator``, ``rng`` (the scheduler's one ``random.Random``),
``parallelizer`` and ``extenders`` (the scheduler's HTTP extenders) come
from the scheduler that built it. Score fans out over the nodes through the
parallelizer (``utils.parallelize``); with ``parallelism=1`` it runs over
them in order on the calling thread.

Permit may allow, reject or ask the pod to wait: a waiting pod is
parked as a ``WaitingPod`` until every waiting plugin allows it, one
rejects it, or the earliest of their timeouts passes (``wait_on_permit``,
called by the binding cycle).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.config.types import Plugins
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.types import NodeInfo
from kubernetes_tpu_torch.utils.parallelize import Parallelizer


def _timed(point: str, status_at: Optional[int] = None):
    """Observe the extension point's duration and status into the
    framework's ``metrics`` (``observe_extension_point``) on the attempts
    whose cycle state draws plugin metrics (``record_plugin_metrics``).
    ``status_at``: the status's index in a tuple result."""
    def wrap(run):
        def timed(self, state, *args):
            if self.metrics is None or not state.record_plugin_metrics:
                return run(self, state, *args)
            start = time.monotonic()
            out = run(self, state, *args)
            status = out if status_at is None else out[status_at]
            self.metrics.observe_extension_point(
                point,
                "Success" if fw.Status.is_ok(status) else status.code_name(),
                time.monotonic() - start, profile=self.profile_name)
            return out
        timed.__doc__ = run.__doc__
        timed.__name__ = run.__name__
        return timed
    return wrap

EXTENSION_POINTS = (
    "queue_sort", "pre_filter", "filter", "post_filter", "pre_score",
    "score", "reserve", "permit", "pre_bind", "bind", "post_bind",
)


MAX_TIMEOUT = 15 * 60.0  # the longest a pod may wait at Permit


class WaitingPod:
    """A pod parked at Permit: the plugins that asked it to wait, and the
    verdict once every one of them allowed it or one rejected it. It is
    rejected when the earliest plugin timeout passes."""

    def __init__(self, pod: Pod, plugin_timeouts: Dict[str, float]):
        self.pod = pod
        self._lock = threading.Lock()
        self._pending = set(plugin_timeouts)
        self._event = threading.Event()
        self._status: Optional[fw.Status] = None
        self._deadline = time.monotonic() + (
            min(plugin_timeouts.values()) if plugin_timeouts else 0.0)

    def pending_plugins(self) -> List[str]:
        with self._lock:
            return sorted(self._pending)

    def allow(self, plugin_name: str) -> None:
        with self._lock:
            self._pending.discard(plugin_name)
            if self._pending and self._status is None:
                return
            if self._status is None:
                self._status = fw.Status(fw.SUCCESS)
        self._event.set()

    def reject(self, plugin_name: str, msg: str = "") -> None:
        with self._lock:
            if self._status is None:
                self._status = fw.Status(
                    fw.UNSCHEDULABLE, msg or f"rejected by {plugin_name}",
                    failed_plugin=plugin_name)
        self._event.set()

    def wait(self) -> fw.Status:
        """Block until the verdict, or until the deadline rejects it."""
        remaining = self._deadline - time.monotonic()
        if not self._event.wait(timeout=max(0.0, remaining)):
            return fw.Status(
                fw.UNSCHEDULABLE,
                f"pod {self.pod.full_name()} rejected: timed out waiting "
                "at Permit")
        with self._lock:
            return self._status or fw.Status(fw.SUCCESS)


def wiring_of(plugins: Plugins) -> Dict[str, List[Tuple[str, int]]]:
    """Extension point -> the enabled (plugin name, weight) entries."""
    return {p: [(e.name, e.weight) for e in plugins.get(p).enabled]
            for p in EXTENSION_POINTS}


class Framework:
    """``plugins``: the enabled sets of a ``config.types.Plugins``, each
    extension point's (plugin name, weight) entries in order (weights
    count for Score only); ``registry`` maps a plugin name
    to ``factory(args, handle)``; ``plugin_args`` maps a plugin name to
    its arguments (default: none), which the framework keeps
    (``plugin_args``). Each named plugin is built once.
    ``metrics`` (a ``SchedulerMetrics``) takes the extension points'
    durations; ``event_recorder`` is the handle's recorder, which
    preemption writes ``Preempted`` events to; ``parallelizer`` fans
    Score out (default: one worker)."""

    def __init__(self, registry: Dict[str, Callable],
                 plugins: Plugins, snapshot: Callable, client,
                 pod_nominator=None,
                 rng=None, profile_name: str = "default-scheduler",
                 plugin_args: Optional[Dict[str, dict]] = None,
                 metrics=None, event_recorder=None,
                 parallelizer: Optional[Parallelizer] = None,
                 extenders=()):
        self.profile_name = profile_name
        self.metrics = metrics
        self.event_recorder = event_recorder
        self._snapshot = snapshot
        self.client = client
        self.pod_nominator = pod_nominator
        self.rng = rng
        self.parallelizer = parallelizer or Parallelizer(1)
        self.extenders = extenders
        self.handle = self  # plugins receive the framework as their handle
        self._plugins = wiring_of(plugins)
        # plugin name -> the arguments it was built with (empty: none)
        self.plugin_args: Dict[str, dict] = {}
        instances: Dict[str, fw.Plugin] = {}
        for point in EXTENSION_POINTS:
            for name, _ in self._plugins[point]:
                if name in instances:
                    continue
                factory = registry.get(name)
                if factory is None:
                    raise ValueError(f"plugin {name!r} not in registry")
                args = self.plugin_args[name] = dict(
                    (plugin_args or {}).get(name, {}))
                instances[name] = factory(dict(args), self)
        self._instances = instances

        def plugin_list(point: str) -> List[fw.Plugin]:
            return [instances[name] for name, _ in self._plugins[point]]

        self.queue_sort_plugins = plugin_list("queue_sort")
        self.pre_filter_plugins = plugin_list("pre_filter")
        self.filter_plugins = plugin_list("filter")
        self.post_filter_plugins = plugin_list("post_filter")
        self.pre_score_plugins = plugin_list("pre_score")
        self.score_plugins = plugin_list("score")
        self.reserve_plugins = plugin_list("reserve")
        self.permit_plugins = plugin_list("permit")
        self.pre_bind_plugins = plugin_list("pre_bind")
        self.bind_plugins = plugin_list("bind")
        self.post_bind_plugins = plugin_list("post_bind")
        self.score_plugin_weight = dict(self._plugins["score"])
        for name, w in self.score_plugin_weight.items():
            if w <= 0:
                raise ValueError(f"score plugin {name} has non-positive weight")
        # PostFilter runs, for the batch path's all-static declines
        self.post_filter_runs = 0
        # pods parked at Permit, by uid
        self._waiting_lock = threading.Lock()
        self._waiting_pods: Dict[str, WaitingPod] = {}

    # ------------------------------------------------------------------
    def snapshot(self):
        return self._snapshot()

    def get_plugin(self, name: str) -> Optional[fw.Plugin]:
        return self._instances.get(name)

    def has_filter_plugins(self) -> bool:
        return bool(self.filter_plugins)

    def has_score_plugins(self) -> bool:
        return bool(self.score_plugins)

    def has_post_filter_plugins(self) -> bool:
        return bool(self.post_filter_plugins)

    def list_plugins(self) -> Dict[str, List[str]]:
        """Extension point -> its plugins' names, in order."""
        return {p: [name for name, _ in self._plugins[p]]
                for p in EXTENSION_POINTS}

    def wiring(self) -> Dict[str, List[Tuple[str, int]]]:
        """Extension point -> its (plugin name, weight) entries."""
        return {p: list(v) for p, v in self._plugins.items()}

    # ------------------------------------------------------------------
    @_timed("PreFilter")
    def run_pre_filter_plugins(self, state: CycleState, pod: Pod
                               ) -> Optional[fw.Status]:
        for p in self.pre_filter_plugins:
            status = p.pre_filter(state, pod)
            if not fw.Status.is_ok(status):
                status.with_failed_plugin(p.name())
                if status.is_unschedulable():
                    return status
                return fw.Status(
                    fw.ERROR,
                    f"running PreFilter plugin {p.name()}: {status.message()}",
                    failed_plugin=p.name())
        return None

    def run_pre_filter_extension_add_pod(self, state: CycleState, pod: Pod,
                                         pod_to_add: Pod,
                                         node_info: NodeInfo
                                         ) -> Optional[fw.Status]:
        for p in self.pre_filter_plugins:
            ext = p.pre_filter_extensions()
            if ext is not None:
                status = ext.add_pod(state, pod, pod_to_add, node_info)
                if not fw.Status.is_ok(status):
                    return status
        return None

    def run_pre_filter_extension_remove_pod(self, state: CycleState,
                                            pod: Pod, pod_to_remove: Pod,
                                            node_info: NodeInfo
                                            ) -> Optional[fw.Status]:
        for p in self.pre_filter_plugins:
            ext = p.pre_filter_extensions()
            if ext is not None:
                status = ext.remove_pod(state, pod, pod_to_remove, node_info)
                if not fw.Status.is_ok(status):
                    return status
        return None

    def run_filter_plugins(self, state: CycleState, pod: Pod,
                           node_info: NodeInfo) -> Optional[fw.Status]:
        for p in self.filter_plugins:
            status = p.filter(state, pod, node_info)
            if not fw.Status.is_ok(status):
                if not status.is_unschedulable():
                    status = fw.Status(
                        fw.ERROR,
                        f"running {p.name()} filter plugin: "
                        f"{status.message()}")
                status.with_failed_plugin(p.name())
                return status
        return None

    def run_filter_plugins_with_nominated_pods(self, state: CycleState,
                                               pod: Pod, node_info: NodeInfo
                                               ) -> Optional[fw.Status]:
        """Filters up to twice: once with the node's nominated pods of
        equal or higher priority added, and, when that passed and such
        pods exist, once without them (a filter like anti-affinity can
        pass only while they are absent)."""
        for attempt in range(2):
            state_to_use, info_to_use = state, node_info
            if attempt == 0:
                added, state_to_use, info_to_use = self._add_nominated_pods(
                    state, pod, node_info)
                if not added:
                    return self.run_filter_plugins(state, pod, node_info)
            status = self.run_filter_plugins(state_to_use, pod, info_to_use)
            if not fw.Status.is_ok(status):
                return status
        return None

    def _add_nominated_pods(self, state: CycleState, pod: Pod,
                            node_info: NodeInfo
                            ) -> Tuple[bool, CycleState, NodeInfo]:
        nominator = self.pod_nominator
        if nominator is None or node_info.node is None:
            return False, state, node_info
        relevant = [
            pi for pi in nominator.nominated_pods_for_node(node_info.node.name)
            if pi.pod.uid != pod.uid and pi.pod.priority() >= pod.priority()]
        if not relevant:
            return False, state, node_info
        node_out = node_info.clone()
        state_out = state.clone()
        for pi in relevant:
            node_out.add_pod_info(pi)
            self.run_pre_filter_extension_add_pod(state_out, pod, pi.pod,
                                                  node_out)
        return True, state_out, node_out

    @_timed("PostFilter", 1)
    def run_post_filter_plugins(self, state: CycleState, pod: Pod,
                                statuses: fw.NodeToStatusMap
                                ) -> Tuple[Optional[fw.PostFilterResult],
                                           fw.Status]:
        self.post_filter_runs += 1
        final = fw.Status(fw.UNSCHEDULABLE, "no candidates")
        for p in self.post_filter_plugins:
            result, status = p.post_filter(state, pod, statuses)
            if fw.Status.is_ok(status):
                return result, status or fw.Status(fw.SUCCESS)
            if not (status and status.is_unschedulable()):
                return None, fw.Status(
                    fw.ERROR,
                    f"running PostFilter plugin {p.name()}: "
                    f"{status.message()}")
            final = status
        return None, final

    @_timed("PreScore")
    def run_pre_score_plugins(self, state: CycleState, pod: Pod,
                              nodes: List) -> Optional[fw.Status]:
        for p in self.pre_score_plugins:
            status = p.pre_score(state, pod, nodes)
            if not fw.Status.is_ok(status):
                return fw.Status(
                    fw.ERROR,
                    f"running PreScore plugin {p.name()}: {status.message()}")
        return None

    @_timed("Score", 1)
    def run_score_plugins(self, state: CycleState, pod: Pod,
                          node_names: List[str]
                          ) -> Tuple[Dict[str, List[fw.NodeScore]],
                                     Optional[fw.Status]]:
        """Three passes: each plugin scores each node (the nodes fanned
        out over the parallelizer), each plugin normalizes its scores,
        each score is weighted. Returns plugin
        name -> [NodeScore] in node order."""
        scores: Dict[str, List[fw.NodeScore]] = {
            p.name(): [fw.NodeScore(n, 0) for n in node_names]
            for p in self.score_plugins}
        errs: List[str] = []

        def score_node(i: int) -> None:
            node_name = node_names[i]
            for p in self.score_plugins:
                s, status = p.score(state, pod, node_name)
                if not fw.Status.is_ok(status):
                    errs.append(f"{p.name()}: {status.message()}")
                    return
                scores[p.name()][i] = fw.NodeScore(node_name, s)

        self.parallelizer.until(len(node_names), score_node)
        if errs:
            return scores, fw.Status(fw.ERROR, *errs)
        for p in self.score_plugins:
            ext = p.score_extensions()
            if ext is not None:
                status = ext.normalize_score(state, pod, scores[p.name()])
                if not fw.Status.is_ok(status):
                    return scores, fw.Status(
                        fw.ERROR,
                        f"normalizing {p.name()}: {status.message()}")
        for p in self.score_plugins:
            weight = self.score_plugin_weight[p.name()]
            for ns in scores[p.name()]:
                if not (fw.MIN_NODE_SCORE <= ns.score <= fw.MAX_NODE_SCORE):
                    return scores, fw.Status(
                        fw.ERROR,
                        f"plugin {p.name()} returns an invalid score "
                        f"{ns.score}")
                ns.score *= weight
        return scores, None

    @_timed("Reserve")
    def run_reserve_plugins_reserve(self, state: CycleState, pod: Pod,
                                    node_name: str) -> Optional[fw.Status]:
        for i, p in enumerate(self.reserve_plugins):
            status = p.reserve(state, pod, node_name)
            if not fw.Status.is_ok(status):
                # roll back the reservations made, in reverse order
                for q in reversed(self.reserve_plugins[:i]):
                    q.unreserve(state, pod, node_name)
                return fw.Status(
                    fw.ERROR,
                    f"running Reserve plugin {p.name()}: {status.message()}")
        return None

    def run_reserve_plugins_unreserve(self, state: CycleState, pod: Pod,
                                      node_name: str) -> None:
        for p in reversed(self.reserve_plugins):
            p.unreserve(state, pod, node_name)

    @_timed("Permit")
    def run_permit_plugins(self, state: CycleState, pod: Pod,
                           node_name: str) -> Optional[fw.Status]:
        """None when every plugin allows; the rejection or error
        otherwise; a Wait status when a plugin asked the pod to wait,
        which parks it as a ``WaitingPod`` until ``wait_on_permit``."""
        plugin_timeouts: Dict[str, float] = {}
        for p in self.permit_plugins:
            status, timeout = p.permit(state, pod, node_name)
            if fw.Status.is_ok(status):
                continue
            if status.is_unschedulable():
                return status.with_failed_plugin(p.name())
            if status.code == fw.WAIT:
                plugin_timeouts[p.name()] = min(
                    timeout if timeout and timeout > 0 else MAX_TIMEOUT,
                    MAX_TIMEOUT)
                continue
            return fw.Status(
                fw.ERROR,
                f"running Permit plugin {p.name()}: {status.message()}")
        if plugin_timeouts:
            with self._waiting_lock:
                self._waiting_pods[pod.uid] = WaitingPod(pod,
                                                         plugin_timeouts)
            return fw.Status(
                fw.WAIT, f"pod waiting at permit: {sorted(plugin_timeouts)}")
        return None

    def wait_on_permit(self, pod: Pod) -> Optional[fw.Status]:
        """Block while the pod waits at Permit; None once allowed (or
        when it never waited), the rejection otherwise."""
        with self._waiting_lock:
            wp = self._waiting_pods.get(pod.uid)
        if wp is None:
            return None
        try:
            status = wp.wait()
        finally:
            with self._waiting_lock:
                self._waiting_pods.pop(pod.uid, None)
        return None if status.is_success() else status

    def get_waiting_pod(self, uid: str) -> Optional[WaitingPod]:
        with self._waiting_lock:
            return self._waiting_pods.get(uid)

    def iterate_waiting_pods(self, fn: Callable[[WaitingPod], None]) -> None:
        with self._waiting_lock:
            pods = list(self._waiting_pods.values())
        for wp in pods:
            fn(wp)

    def reject_waiting_pod(self, uid: str) -> bool:
        """Reject a pod waiting at Permit; False when it is not waiting."""
        wp = self.get_waiting_pod(uid)
        if wp is None:
            return False
        wp.reject("", "removed from waiting")
        return True

    @_timed("PreBind")
    def run_pre_bind_plugins(self, state: CycleState, pod: Pod,
                             node_name: str) -> Optional[fw.Status]:
        for p in self.pre_bind_plugins:
            status = p.pre_bind(state, pod, node_name)
            if not fw.Status.is_ok(status):
                return fw.Status(
                    fw.ERROR,
                    f"running PreBind plugin {p.name()}: {status.message()}")
        return None

    @_timed("Bind")
    def run_bind_plugins(self, state: CycleState, pod: Pod,
                         node_name: str) -> Optional[fw.Status]:
        if not self.bind_plugins:
            return fw.Status(fw.ERROR, "no bind plugin configured")
        for p in self.bind_plugins:
            status = p.bind(state, pod, node_name)
            if status is not None and status.code == fw.SKIP:
                continue
            if not fw.Status.is_ok(status):
                return fw.Status(
                    fw.ERROR,
                    f"running Bind plugin {p.name()}: {status.message()}")
            return status
        return fw.Status(fw.ERROR, "all bind plugins skipped")

    def run_bind_plugins_bulk(self, states: List[CycleState],
                              pods: List[Pod], node_names: List[str]
                              ) -> List[Optional[fw.Status]]:
        """Bind a whole batch: through the one bind plugin's ``bind_many``
        when it has one (one store call for the batch), else pod by pod.
        Statuses come back positionally; each bind is its own
        transaction."""
        if len(self.bind_plugins) == 1 and hasattr(self.bind_plugins[0],
                                                   "bind_many"):
            name = self.bind_plugins[0].name()
            return [
                s if fw.Status.is_ok(s) else fw.Status(
                    fw.ERROR, f"running Bind plugin {name}: {s.message()}")
                for s in self.bind_plugins[0].bind_many(states, pods,
                                                        node_names)]
        return [self.run_bind_plugins(state, pod, node)
                for state, pod, node in zip(states, pods, node_names)]

    def run_post_bind_plugins(self, state: CycleState, pod: Pod,
                              node_name: str) -> None:
        for p in self.post_bind_plugins:
            p.post_bind(state, pod, node_name)
