"""The port's critical-path attribution against the JAX package's: the
same merged documents, built from identical synthetic rings (the JAX
package's own cases, and seeded random rings with pods, cycle spans and
seam spans), give the same aggregate and per-pod paths to 1e-9; the
phase classification agrees; a harness row's ``critical_path`` covers
its pods."""

import numpy as np
import pytest

from kubernetes_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from kubernetes_tpu.observability import fleettrace as jax_ft
from kubernetes_tpu.observability.tracer import Tracer as JaxTracer
from kubernetes_tpu_torch.metrics.registry import MetricsRegistry
from kubernetes_tpu_torch.observability import fleettrace as ft
from kubernetes_tpu_torch.observability.tracer import Tracer


def _close(a, b, tol=1e-9):
    """Recursive equality, floats to ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=tol)
    else:
        assert a == b


def _pair():
    return (JaxTracer(component="t", sample_rate=1.0,
                      registry=JaxRegistry()),
            Tracer(component="t", sample_rate=1.0,
                   registry=MetricsRegistry()))


def _merged(ref, port):
    jfed, fed = jax_ft.TraceFederation(), ft.TraceFederation()
    jfed.absorb_local(ref, "solo")
    fed.absorb_local(port, "solo")
    return jfed.merged(), fed.merged()


def _priority_sweep(tracers, now):
    # the JAX package's test_priority_sweep_and_unattributed
    for t in tracers:
        t.record("rest.ingest", now - 1.0, now - 0.998, trace="p1")
        t.record("queue.wait", now - 0.9, now - 0.4, trace="p1")
        t.record("solve.commit", now - 0.6, now - 0.2)
        t.record("sched.bind", now - 0.2, now, trace="p1")


def _seam(tracers, now):
    # the JAX package's test_seam_spans_attribute_overlapping_stalls
    for t in tracers:
        t.record("rest.ingest", now - 1.0, now - 0.99, trace="p1")
        t.record("sched.bind", now - 0.1, now, trace="p1")
        t.record("reshard.freeze", now - 0.8, now - 0.3, trace="seam:4")


def _random(seed):
    def fill(tracers, now):
        rng = np.random.default_rng(seed)
        names = ["queue.wait", "sched.bind", "solve.encode", "solve.pack",
                 "solve.device", "solve.block", "solve.commit", "bind.bulk",
                 "queue.cycle", "trace.Scheduling", "watch.deliver"]
        for _ in range(300):
            start = now - float(rng.uniform(0, 3))
            end = start + float(rng.exponential(0.08))
            name = names[int(rng.integers(len(names)))]
            r = rng.random()
            trace = (f"pod-{int(rng.integers(40))}" if r < 0.6
                     else "seam:1" if r < 0.65 else "")
            for t in tracers:
                t.record(name, start, end, trace=trace)
                if r > 0.95:
                    t.event("solve.staleness", trace=trace, at_mono=end)
    return fill


@pytest.mark.parametrize("fill", [_priority_sweep, _seam, _random(0),
                                  _random(1), _random(2)],
                         ids=["priority_sweep", "seam", "random0",
                              "random1", "random2"])
def test_critical_path_equals_the_reference(fill):
    ref, port = _pair()
    now = port._epoch_mono + 10.0
    fill((ref, port), now)
    ref._epoch_mono = port._epoch_mono
    jdoc, doc = _merged(ref, port)
    _close(doc["traceEvents"], jdoc["traceEvents"])
    want = jax_ft.critical_path(jdoc)
    got = ft.critical_path(doc)
    _close(got, want)
    # and the port's analysis of the JAX package's own document
    _close(ft.critical_path(jdoc), want)
    assert got["pods"] > 0


def test_priority_sweep_attribution():
    _, port = _pair()
    now = port._epoch_mono + 10.0
    _priority_sweep((port,), now)
    cp = ft.critical_path(_merged(port, port)[1])
    pod = cp["per_pod"][0]
    assert pod["phases_ms"]["commit"] == pytest.approx(400, abs=1e-6)
    assert pod["phases_ms"]["queue"] == pytest.approx(300, abs=1e-6)
    assert 0.05 < cp["unattributed_share"] < 0.15 and cp["top"] == "commit"


@pytest.mark.parametrize("name", ["rest.ingest", "rest.POST", "queue.wait",
                                  "queue.cycle", "solve.encode",
                                  "solve.pack", "solve.device",
                                  "solve.block", "solve.commit",
                                  "sched.bind", "bind.bulk",
                                  "watch.deliver", "reshard.freeze",
                                  "trace.Scheduling", "unrelated"])
def test_phase_of_equals_the_reference(name):
    assert ft.phase_of(name) == jax_ft.phase_of(name)


def test_collect_fleet_trace_local_only():
    _, port = _pair()
    now = port._epoch_mono + 10.0
    _priority_sweep((port,), now)
    doc, cp = ft.collect_fleet_trace(local=[("scheduler", port)],
                                     window_s=1e6, max_pods=1)
    assert doc["otherData"]["instances"].keys() == {"scheduler"}
    assert doc["otherData"]["scrape_errors"] == []
    assert cp["pods"] == 1 and len(cp["per_pod"]) == 1
