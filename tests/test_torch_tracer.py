"""The port's tracer against the JAX package's: on the same rows through
both harnesses (every pod sampled), the same span names with the same
counts and the same spans per pod; ``phase_stats`` and
``export_perfetto`` of the same synthetic ring; the head-sampling
decision and the ``X-Ktpu-Trace`` helpers; the step trace of the serial
path. Tolerance: counts and structure exact, seconds to 1e-9."""

import numpy as np
import pytest

from kubernetes_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from kubernetes_tpu.observability import tracer as jax_tracer_mod
from kubernetes_tpu_torch.metrics.registry import MetricsRegistry
from kubernetes_tpu_torch.observability import tracer as tracer_mod
from kubernetes_tpu_torch.utils.trace import Trace
from test_torch_metrics import run_both


@pytest.mark.parametrize("name", ["SchedulingBasic", "Unschedulable",
                                  "Preemption"])
def test_span_names_and_per_pod_spans_equal_the_reference(name):
    rows = run_both(name)
    ref_names, ref_pods = rows["jax"]["spans"]
    names, pods = rows["port"]["spans"]
    assert names == ref_names
    assert pods == ref_pods
    assert sum(pods.values()) == sum(ref_pods.values()) > 0
    assert {"queue.wait", "sched.bind", "queue.cycle", "solve.commit",
            "bind.bulk"} <= set(names)


def _rings(seed=3, n=60):
    """Both tracers with the same seeded spans and instants at the same
    monotonic stamps."""
    ref = jax_tracer_mod.Tracer(component="t", sample_rate=1.0,
                                registry=JaxRegistry())
    port = tracer_mod.Tracer(component="t", sample_rate=1.0,
                             registry=MetricsRegistry())
    rng = np.random.default_rng(seed)
    base = port._epoch_mono + 1.0
    names = ["queue.wait", "solve.encode", "solve.commit", "sched.bind",
             "bind.bulk"]
    for i in range(n):
        start = base + float(rng.uniform(0, 2))
        end = start + float(rng.exponential(0.05))
        name = names[int(rng.integers(len(names)))]
        trace = f"pod-{int(rng.integers(8))}" if rng.random() < 0.6 else ""
        for t in (ref, port):
            t.record(name, start, end, trace=trace, cycle=i)
            if i % 7 == 0:
                t.event("solve.staleness", at_mono=end, staleness_ms=1.5)
    for t in (ref, port):
        t._epoch_mono = port._epoch_mono
    return ref, port


def test_phase_stats_equal_on_a_synthetic_ring():
    ref, port = _rings()
    want, got = ref.phase_stats(), port.phase_stats()
    assert got.keys() == want.keys()
    for name in want:
        assert got[name]["count"] == want[name]["count"]
        for k in ("total_s", "p50_s", "p99_s"):
            assert got[name][k] == pytest.approx(want[name][k], abs=1e-9)


def test_export_perfetto_has_the_same_structure():
    ref, port = _rings()
    want = ref.export_perfetto(window_s=1e6)
    got = port.export_perfetto(window_s=1e6)
    assert got.keys() == want.keys()
    assert got["otherData"].keys() == want["otherData"].keys()
    assert len(got["traceEvents"]) == len(want["traceEvents"])
    for a, b in zip(got["traceEvents"], want["traceEvents"]):
        assert (a["name"], a["ph"], sorted(a)) == (b["name"], b["ph"],
                                                   sorted(b))
        assert a["args"] == b["args"] or a["ph"] == "M"
        assert a["ts"] == pytest.approx(b["ts"], abs=1e-3)   # µs
        assert a.get("dur", 0.0) == pytest.approx(b.get("dur", 0.0),
                                                  abs=1e-3)


def test_sampling_and_trace_header_equal_the_reference():
    ref = jax_tracer_mod.Tracer(sample_rate=0.25, seed=11,
                                registry=JaxRegistry())
    port = tracer_mod.Tracer(sample_rate=0.25, seed=11,
                             registry=MetricsRegistry())
    uids = [f"uid-{i}" for i in range(400)]
    picked = [port.sampled(u) for u in uids]
    assert picked == [ref.sampled(u) for u in uids]
    assert 40 < sum(picked) < 160
    assert port.sampled("x", inbound=True) and not port.sampled(
        "x", inbound=False)
    for trace, parent, sampled in (("p;1", 42, True), ("u", 0, False)):
        hdr = tracer_mod.format_trace_header(trace, parent, sampled)
        assert hdr == jax_tracer_mod.format_trace_header(trace, parent,
                                                         sampled)
        assert tuple(tracer_mod.parse_trace_header(hdr)) == tuple(
            jax_tracer_mod.parse_trace_header(hdr))
    for bad in ("", "t", "t;x;1", "t;1;2", None):
        assert tracer_mod.parse_trace_header(bad) is None


def test_step_trace_records_a_span_with_its_steps(monkeypatch):
    t = tracer_mod.Tracer(sample_rate=1.0, registry=MetricsRegistry())
    monkeypatch.setattr(tracer_mod, "_default", t)
    with Trace("Scheduling", pod="default/p", uid="u1") as trace:
        trace.step("Computing predicates done")
        trace.step("Prioritizing done")
    names = [(r[0], r[1], r[4]) for r in t._ring]
    assert names == [("trace.Scheduling", "X", "u1"),
                     ("step.Computing predicates done", "i", "u1"),
                     ("step.Prioritizing done", "i", "u1")]
    trace.log_if_long(0.0)   # recorded once
    assert len(t) == 3


def test_disabled_tracer_and_dump(tmp_path):
    t = tracer_mod.Tracer(sample_rate=1.0, registry=MetricsRegistry(),
                          dump_dir=str(tmp_path))
    t.record("solve.commit", 0.0, 1.0)
    path = t.dump(reason="manual")
    assert path and path.startswith(str(tmp_path))
    t.configure(enabled=False)
    t.clear()
    t.record("solve.commit", 0.0, 1.0)
    t.event("x")
    assert len(t) == 0 and not t.sampled("u")
