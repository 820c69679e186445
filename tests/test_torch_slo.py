"""The port's SLO engine against the JAX package's: the same samples, fed
to both through their own registries on an injected clock, give the same
verdicts (``evaluate()`` equal, burn rates and p99s included); the
default SLOs are the JAX package's, ``rest_availability`` (over the
apiserver's APF counters) included; the freshness row summary agrees."""

import numpy as np
import pytest

from kubernetes_tpu.metrics import registry as jax_registry
from kubernetes_tpu.metrics import freshness_metrics as jax_fresh
from kubernetes_tpu.observability import slo as jax_slo
from kubernetes_tpu_torch.metrics import freshness_metrics as fresh
from kubernetes_tpu_torch.metrics import registry
from kubernetes_tpu_torch.observability import slo


def _latency(name="lat", threshold=1.0, objective=0.99):
    return dict(name=name, description="d", metric="t_lat",
                threshold_s=threshold, objective=objective)


def _error_ratio():
    return dict(name="avail", description="d", metric="t_rejected_total",
                kind="error_ratio", total_metric="t_dispatched_total",
                objective=0.999)


class _Side:
    """One package's registry, series and engine on a shared clock."""

    def __init__(self, reg_mod, slo_mod, defs, clock, **kw):
        self.reg = reg_mod.MetricsRegistry()
        self.hist = self.reg.register(reg_mod.Histogram(
            "t_lat", "x", ("result",), buckets=(0.1, 1.0, 5.0)))
        self.bad = self.reg.register(reg_mod.Counter("t_rejected_total",
                                                     "x", ("code",)))
        self.ok = self.reg.register(reg_mod.Counter("t_dispatched_total",
                                                    "x"))
        self.engine = slo_mod.SLOEngine(
            slos=[slo_mod.SLODef(**d) for d in defs],
            registries=[self.reg], enabled=True, clock=lambda: clock[0],
            **kw)
        # the engine's dumps and mirrors must not depend on a process
        # tracer's state
        self.engine._on_breach = lambda *a: None


def _scenario(seed, steps):
    """Seeded (clock, good latencies, bad latencies, ok, rejected) steps."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(steps):
        t += float(rng.uniform(1, 120))
        bad_rate = float(rng.choice([0.0, 0.005, 0.02, 0.5, 1.0]))
        n = int(rng.integers(0, 300))
        nbad = int(n * bad_rate)
        good = [float(v) for v in rng.uniform(0.001, 0.9, n - nbad)]
        bad = [float(v) for v in rng.uniform(1.1, 8.0, nbad)]
        out.append((t, good, bad, int(rng.integers(0, 2000)),
                    int(rng.integers(0, 5))))
    return out


@pytest.mark.parametrize("seed,windows", [
    (0, {}), (1, {"fast_window_s": 60.0, "slow_window_s": 600.0}),
    (2, {"fast_window_s": 30.0, "slow_window_s": 120.0}),
    (3, {"fast_burn": 2.0, "slow_burn": 1.0}),
])
def test_verdicts_equal_the_reference(seed, windows):
    clock = [0.0]
    defs = [_latency(), _latency("lat_loose", 5.0, 0.9), _error_ratio()]
    ref = _Side(jax_registry, jax_slo, defs, clock, **windows)
    port = _Side(registry, slo, defs, clock, **windows)
    for side in (ref, port):
        side.engine.tick()
    for t, good, bad, ok, rejected in _scenario(seed, 25):
        clock[0] = t
        for side in (ref, port):
            side.hist.observe_many(good, "scheduled")
            side.hist.observe_many(bad, "scheduled")
            side.ok.inc(amount=ok)
            side.bad.inc("429", amount=rejected)
        assert port.engine.evaluate() == ref.engine.evaluate()


def test_reset_and_disabled_equal_the_reference():
    clock = [0.0]
    ref = _Side(jax_registry, jax_slo, [_latency()], clock)
    port = _Side(registry, slo, [_latency()], clock)
    for side in (ref, port):
        side.engine.tick()
        side.hist.observe_many([3.0] * 10, "scheduled")
    clock[0] = 1.0
    assert port.engine.evaluate() == ref.engine.evaluate()
    for side in (ref, port):
        side.engine.reset(fast_window_s=30.0, slow_window_s=120.0)
        side.engine.tick()
    clock[0] = 2.0
    got = port.engine.evaluate()
    assert got == ref.engine.evaluate()
    assert got["slos"]["lat"]["violated"] is False
    assert slo.SLOEngine(enabled=False).evaluate() == \
        jax_slo.SLOEngine(enabled=False).evaluate()


def test_default_slos_are_the_reference_s_without_apf():
    want = {s.name: s for s in jax_slo.default_slos()}
    got = {s.name: s for s in slo.default_slos()}
    assert set(want) == set(got)
    for name, s in got.items():
        assert (s.metric, s.kind, s.threshold_s, s.objective, s.labels,
                s.total_metric) == (
            want[name].metric, want[name].kind, want[name].threshold_s,
            want[name].objective, want[name].labels,
            want[name].total_metric)


def test_freshness_row_summary_equals_the_reference(monkeypatch):
    ref = jax_fresh.FreshnessMetrics(jax_registry.MetricsRegistry())
    port = fresh.FreshnessMetrics(registry.MetricsRegistry())
    monkeypatch.setattr(jax_fresh, "_default", ref)
    monkeypatch.setattr(fresh, "_default", port)
    rng = np.random.default_rng(5)
    for m in (ref, port):
        rng = np.random.default_rng(5)
        m.snapshot_staleness_seconds.observe_many(
            [float(v) for v in rng.exponential(0.2, 100)])
        m.watch_delivery_seconds.observe_many(
            [float(v) for v in rng.exponential(0.01, 50)], "Pod")
    dev = {"max_staleness_s": 0.4321}
    statuses = {"lat": {"violated": True, "events_fast": 3},
                "quiet": {"violated": False, "events_fast": 0}}
    assert fresh.freshness_row_summary(dev, statuses) == \
        jax_fresh.freshness_row_summary(dev, statuses)
    port.reset_window()
    assert port.snapshot_staleness_seconds.count() == 0
