"""The port's metrics against the JAX package's: the registry's
exposition text, bucket counts and quantiles on the same observations
(seeded with numpy), the scheduler's, solver's and freshness series
(names, labels, buckets), and, after the same rows through both
harnesses, the scheduler's ``schedule_attempts{result}`` and e2e
histogram counts.

``run_both`` runs one row through both harnesses (the JAX one with its
planes scan and a pinned chunk, the port on the CPU) with both process
tracers sampling every pod, and returns what the other differential
tests of this slice read: the schedulers' metrics, the tracers' spans,
the stored Events and the placements. Tolerance: counts and text exact,
quantiles to 1e-12."""

import collections
import functools

import numpy as np
import pytest

from kubernetes_tpu.harness import perf as jax_perf
from kubernetes_tpu.harness import workloads as jax_workloads
from kubernetes_tpu.metrics import registry as jax_registry
from kubernetes_tpu.metrics.freshness_metrics import (
    FreshnessMetrics as JaxFreshness,
)
from kubernetes_tpu.metrics.scheduler_metrics import (
    SchedulerMetrics as JaxSchedulerMetrics,
)
from kubernetes_tpu.metrics.solver_metrics import (
    SolverMetrics as JaxSolverMetrics,
)
from kubernetes_tpu.observability import get_tracer as jax_get_tracer
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.metrics import registry
from kubernetes_tpu_torch.metrics.freshness_metrics import FreshnessMetrics
from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics
from kubernetes_tpu_torch.metrics.solver_metrics import SolverMetrics
from kubernetes_tpu_torch.observability.tracer import get_tracer

# (row, (nodes, init pods, measured pods), max_batch, port seed)
ROWS = {
    "SchedulingBasic": ((200, 0, 400), 128, None),
    "Unschedulable": ((50, 40, 100), 40, None),
    "Preemption": ((50, 50, 50), 64, 1),
}


def _spans(tracer):
    """(span name -> count, how many pods have each per-pod span set)
    of the ring: a pod's set is its (span name, count) pairs (uids differ
    between the packages, so pods are not matched by their trace id)."""
    names = collections.Counter()
    per_pod = collections.defaultdict(collections.Counter)
    for rec in list(tracer._ring):
        name, ph, trace = rec[0], rec[1], rec[4]
        if ph != "X":
            continue
        names[name] += 1
        if trace:
            per_pod[trace][name] += 1
    return dict(names), collections.Counter(
        tuple(sorted(c.items())) for c in per_pod.values())


def _events(client):
    return sorted((e.involved_object.name, e.type, e.reason, e.message,
                   e.count) for e in client.list_events())


@functools.lru_cache(maxsize=None)
def run_both(name):
    """The row through both harnesses: {"jax": ..., "port": ...}, each
    with its scheduler's metrics, spans, Events and placements."""
    (nodes, init, pods), max_batch, seed = ROWS[name]
    jax_tracer, tracer = jax_get_tracer(), get_tracer()
    saved = [(t, t.enabled, t.sample_rate) for t in (jax_tracer, tracer)]
    for t in (jax_tracer, tracer):
        t.configure(enabled=True, sample_rate=1.0)
    out = {}
    try:
        def hook(sched, _bs):
            sched.recorder.flush_now()
            out["jax"] = {
                "metrics": sched.metrics, "events": _events(sched.client),
                "placements": {p.metadata.name: p.spec.node_name
                               for p in sched.client.list_pods()}}

        jax_perf.run_workload(
            name, jax_workloads.make_workload(name, nodes, init, pods),
            use_batch=True, backend_factory=XlaPlanesBackend,
            adaptive_chunk=False, max_batch=max_batch, result_hook=hook)
        out["jax"]["spans"] = _spans(jax_tracer)
        held = {}
        res = perf.run_workload(
            name, workloads.make_workload(name, nodes, init, pods),
            device="cpu", max_batch=max_batch, seed=seed,
            configure=lambda bs: held.update(bs=bs))
        sched = held["bs"].sched
        out["port"] = {"metrics": sched.metrics,
                       "events": _events(sched.client),
                       "placements": res.placements,
                       "spans": _spans(tracer), "result": res}
    finally:
        for t, enabled, rate in saved:
            t.configure(enabled=enabled, sample_rate=rate)
    return out


def _fill(reg_mod, reg, rng_seed):
    """The same metrics and seeded observations into ``reg``."""
    rng = np.random.default_rng(rng_seed)
    c = reg.register(reg_mod.Counter("t_total", "a counter\nwith \\ help",
                                     ("result", "profile")))
    g = reg.register(reg_mod.Gauge("t_gauge", "a gauge", ("queue",)))
    h = reg.register(reg_mod.Histogram("t_seconds", "a histogram",
                                       ("phase",)))
    h2 = reg.register(reg_mod.Histogram("t_attempts", "custom buckets",
                                        buckets=(1, 2, 4, 8, 16)))
    for _ in range(200):
        c.inc(str(rng.choice(["scheduled", "unschedulable", "error"])),
              'default"sched')
        g.set(float(rng.integers(0, 50)), str(rng.choice(["a", "b"])))
        h.observe(float(rng.exponential(0.3)),
                  str(rng.choice(["encode", "commit"])))
    h.observe_many([float(v) for v in rng.exponential(2.0, 64)], "device")
    h2.observe_many([int(v) for v in rng.integers(1, 40, 100)])
    return h, h2


def test_exposition_and_buckets_equal_the_reference():
    ref, port = jax_registry.MetricsRegistry(), registry.MetricsRegistry()
    rh, rh2 = _fill(jax_registry, ref, 7)
    ph, ph2 = _fill(registry, port, 7)
    assert port.expose() == ref.expose()
    for label in ("encode", "commit", "device"):
        assert ph.bucket_counts(label) == rh.bucket_counts(label)
        assert ph.count(label) == rh.count(label)
        for q in (0.5, 0.9, 0.99):
            assert ph.quantile(q, label) == pytest.approx(
                rh.quantile(q, label), abs=1e-12)
    assert ph2.bucket_counts() == rh2.bucket_counts()
    counts = [3, 0, 5, 1, 9, 2]
    edges = (0.1, 0.5, 1.0, 2.0, 5.0)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert registry.quantile_from_counts(counts, edges, q) == \
            jax_registry.quantile_from_counts(counts, edges, q)


def _series(obj):
    """name -> (type, label names, buckets) of every series ``obj``
    registered."""
    return {m.name: (m.TYPE, m.label_names, getattr(m, "buckets", None))
            for m in obj.registry.all_metrics()}


@pytest.mark.parametrize("make", [
    lambda: (SchedulerMetrics(), JaxSchedulerMetrics()),
    lambda: (SolverMetrics(registry.MetricsRegistry()),
             JaxSolverMetrics(jax_registry.MetricsRegistry())),
    lambda: (FreshnessMetrics(registry.MetricsRegistry()),
             JaxFreshness(jax_registry.MetricsRegistry())),
], ids=["scheduler", "solver", "freshness"])
def test_series_names_labels_and_buckets_equal_the_reference(make):
    """Every series the port registers is the JAX package's; only the
    freshness informer and read-tier series are left out."""
    port, ref = make()
    got, want = _series(port), _series(ref)
    assert got == {name: want[name] for name in got}
    assert set(want) - set(got) <= {"informer_lag_seconds",
                                    "informer_queue_depth",
                                    "replication_lag_seconds"}


@pytest.mark.parametrize("name", ["SchedulingBasic", "Unschedulable"])
def test_attempts_and_e2e_counts_equal_after_a_row(name):
    rows = run_both(name)
    ref, port = rows["jax"]["metrics"], rows["port"]["metrics"]
    assert sorted(port.schedule_attempts.collect()) == \
        sorted(ref.schedule_attempts.collect())
    assert port.e2e_scheduling_duration.count("scheduled") == \
        ref.e2e_scheduling_duration.count("scheduled")
    assert port.pod_scheduling_attempts.bucket_counts() == \
        ref.pod_scheduling_attempts.bucket_counts()
    assert rows["port"]["placements"] == rows["jax"]["placements"]
    # the commit's per-phase histogram: one observation a committed batch
    assert port.batch_solve_duration.count("commit") == \
        ref.batch_solve_duration.count("commit")
