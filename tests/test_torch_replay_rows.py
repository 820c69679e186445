"""The replay rows in the port against the JAX package: the three
families' traces and node fleets (``workloads/scenarios.py``) at two
scales and two seeds, traces with tenants and their JSONL round trip,
``family_verdicts`` over the same synthetic stats, every ``diagfmt``
segment and ``parse_diag`` of the line, the SLO engine's live tick,
one store-direct mini replay of each family on the CPU and one mini
storm over the REST fabric, holding the invariants the JAX package's
replay tests hold. Tolerance: exact equality (events, node dicts,
verdicts, strings, parses); the mini replays are held by their
invariants and counts."""

import threading
import time
from types import SimpleNamespace

import pytest

from kubernetes_tpu.harness import diagfmt as jax_diagfmt
from kubernetes_tpu.workloads import replay as jax_replay
from kubernetes_tpu.workloads import replay_bench as jax_replay_bench
from kubernetes_tpu.workloads import scenarios as jax_scenarios
from kubernetes_tpu.workloads import trace as jax_trace
from kubernetes_tpu_torch.harness import diagfmt
from kubernetes_tpu_torch.observability.slo import SLOEngine
from kubernetes_tpu_torch.workloads import (
    REPLAY_FAMILIES,
    build_family,
    replay,
    replay_bench,
    run_replay_once,
    run_replay_row,
    trace,
)

FAMILIES = sorted(REPLAY_FAMILIES)


def _events(t):
    return [e.to_dict() for e in t.events]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scale", [0.15, 1.0])
@pytest.mark.parametrize("seed", [11, 23])
def test_family_trace_and_nodes_match_reference(family, scale, seed):
    got = build_family(family, seed, scale)
    want = jax_scenarios.build_family(family, seed, scale)
    assert _events(got) == _events(want)
    assert (got.family, got.seed, got.duration_s) \
        == (want.family, want.seed, want.duration_s)
    assert got.offered_rate == want.offered_rate
    spec, jspec = REPLAY_FAMILIES[family], jax_scenarios.REPLAY_FAMILIES[family]
    assert spec.node_specs(scale) == jspec.node_specs(scale)
    assert (spec.title, spec.checks, spec.tenants, spec.autoscale,
            spec.slo_exempt) == (jspec.title, jspec.checks, jspec.tenants,
                                 jspec.autoscale, jspec.slo_exempt)


def test_tenancy_sizing_and_grid_match_reference():
    for scale in (0.05, 0.15, 0.5, 1.0):
        assert replay_bench._tenancy_sizing(scale) \
            == jax_scenarios._tenancy_sizing(scale)
        assert REPLAY_FAMILIES["gangs"].extras["grid"](scale) \
            == jax_scenarios.mesh_grid(scale)


def test_tenant_traces_and_jsonl_match_reference(tmp_path):
    kw = dict(tenants=("a", "b", "c"), priorities=((0.5, 0), (0.5, 10)))
    got = trace.generate_trace(5, 60, 3.0, **kw)
    want = jax_trace.generate_trace(5, 60, 3.0, **kw)
    assert _events(got) == _events(want)
    trace.write_trace_jsonl(got, tmp_path / "port.jsonl")
    jax_trace.write_trace_jsonl(want, tmp_path / "jax.jsonl")
    assert (tmp_path / "port.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    assert trace.load_trace_jsonl(tmp_path / "jax.jsonl") == got
    tenancy = build_family("tenancy", 11, 0.15)
    trace.write_trace_jsonl(tenancy, tmp_path / "t.jsonl")
    assert _events(jax_trace.load_trace_jsonl(tmp_path / "t.jsonl")) \
        == _events(tenancy)


# ---------------------------------------------------------------------------
# verdicts


def _stats(mod, **kw):
    base = dict(family="storm", injected=10, expected=10, ever_bound=10,
                bound_at_end=4, pending_at_end=0, expired=6, preempted=0,
                lost=0, offered_rate=2.0, duration_s=5.0,
                arrival_to_bind={"all": {"count": 10, "p99": 0.4}})
    base.update(kw)
    return mod.ReplayStats(**base)


STATS_CASES = {
    "clean": {},
    "lost": {"lost": 2},
    "short-injection": {"injected": 9},
    "send-errors": {"send_errors": ["RuntimeError: boom"]},
    "inversion": {"priority_inversions": 3},
    "partial-gang": {"gangs_partial": 1, "gangs_total": 4},
    "serve-within": {"arrival_to_bind": {
        "all": {"count": 4, "p99": 3.0},
        "serve": {"count": 2, "p99": 1.9}}},
    "serve-over": {"arrival_to_bind": {"serve": {"count": 2, "p99": 2.1}}},
    "serve-none": {"arrival_to_bind": {"serve": {"count": 0, "p99": 0.0}}},
}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_family_verdicts_match_reference(family, case):
    got = replay_bench.family_verdicts(
        REPLAY_FAMILIES[family], _stats(replay, **STATS_CASES[case]))
    want = jax_replay_bench.family_verdicts(
        jax_scenarios.REPLAY_FAMILIES[family],
        _stats(jax_replay, **STATS_CASES[case]))
    assert got == want


def test_replay_stats_latency_by_class_matches_reference():
    lat = {"all": {"p99": 0.25}, "serve": {"p99": 0.5}}
    got = _stats(replay, arrival_to_bind=lat)
    want = _stats(jax_replay, arrival_to_bind=lat)
    for cls in ("all", "serve", "batch"):
        assert got.latency_p99_ms(cls) == want.latency_p99_ms(cls)
    assert got.latency_p99_ms() == want.latency_p99_ms() == 250.0


# ---------------------------------------------------------------------------
# diagfmt


class _Hist:
    buckets = (0.005, 0.01, 0.1, 1.0)

    def __init__(self, counts):
        self.counts = counts

    def bucket_counts(self, label):
        return self.counts

    def quantile(self, q, label):
        return 0.0873

    def collect(self):
        return [("h", ("device",), 1.3456, 14), ("h", ("encode",), 0.25, 3)]


DEVPROF = {"cycles": 12, "compiles": 2, "unexpected_compiles": 0,
           "warm_compiles": 2, "device_wait_share": 0.125,
           "pad_waste_pct": 12.34, "h2d_bytes": 1_234_567,
           "d2h_bytes": 45_678, "compile_detector": "cache",
           "max_cycle": {"compiles": 0, "encode_s": 0.1, "dispatch_s": 0.3,
                         "block_s": 0.2}, "donated_bytes": 2_000_000}

SEGMENTS = {
    "phases": ("format_phases", ({"solve.commit": {
        "total_s": 4.321, "count": 8, "p99_s": 0.54},
        "encode": {"total_s": 1.0, "count": 3, "p99_s": 0.01}},)),
    "hist": ("format_hist_segments", (_Hist([]),)),
    "session": ("format_session", (SimpleNamespace(
        incremental_hits=5, rebuilds=2, state_only_rebuilds=1), 512, 0.456,
        3)),
    "devprof": ("format_devprof", (DEVPROF,)),
    "devprof-compile": ("format_devprof", (dict(
        DEVPROF, max_cycle={"compiles": 1}, donated_bytes=0),)),
    "slo": ("format_slo", ({"slos": {
        "a": {"violated": True, "burn_fast": 20.0, "burn_slow": 7.0,
              "budget_remaining_pct": 12.5, "alerting": True},
        "b": {"violated": True, "burn_fast": 3.0},
        "c": {"violated": False}}},)),
    "slo-green": ("format_slo", ({"slos": {"c": {"violated": False}}},)),
    "shards": ("format_shards", ({"partitions": 4, "replicas": 2,
                                  "conflicts": 3, "balance": 0.875,
                                  "watch_streams": 9},)),
    "mesh": ("format_mesh", ({"devices": 8, "shards": 4,
                              "donated": True},)),
    "pipeline": ("format_pipeline", ({"depth": 3, "overlap": 0.71,
                                      "cycles": 40},)),
    "replay": ("format_replay", ({"family": "storm", "rate": 12.5,
                                  "p99_arrival_to_bind_ms": 842.0,
                                  "preempted": 312, "gangs_intact": True,
                                  "lost": 0, "expired": 17,
                                  "inversions": 0},)),
    "replay-min": ("format_replay", ({"family": "gangs",
                                      "gangs_intact": False},)),
    "reshard": ("format_reshard", ({"moves": 3, "frozen_ms": 12.34,
                                    "epoch": 5},)),
    "upgrade": ("format_upgrade", ({"rolled": 6, "frozen_ms_max": 80.0,
                                    "reneg": 2},)),
    "federation": ("format_federation", ({"clusters": 3, "spilled": 40,
                                          "failovers": 1,
                                          "recovery": 0.975},)),
    "readtier": ("format_readtier", ({"replicas": 2, "streams": 30,
                                      "lag_p99_ms": 4.56, "fenced": 1},)),
    "mirror": ("format_mirror", ({"events": 900, "scatter_mb": 0.1234,
                                  "encode_share": 0.01234,
                                  "reseeds": 1},)),
    "critpath": ("format_critpath", ({"pods": 64, "top": "solve",
                                      "top_share": 0.41,
                                      "unattributed_share": 0.02,
                                      "max_skew_ms": 1.5,
                                      "seam_windows": 2},)),
    "e2e": ("format_e2e", (_Hist([0, 3, 0, 9, 1]),)),
    "empty": ("format_replay", (None,)),
}


@pytest.mark.parametrize("case", sorted(SEGMENTS))
def test_diag_segments_match_reference(case):
    name, args = SEGMENTS[case]
    assert getattr(diagfmt, name)(*args) == getattr(jax_diagfmt, name)(*args)


def _line(mod):
    segs = []
    for case in sorted(SEGMENTS):
        name, args = SEGMENTS[case]
        out = getattr(mod, name)(*args)
        segs.extend(out if isinstance(out, list) else [out])
    return mod.format_diag(segs)


def test_diag_line_and_parse_match_reference():
    line = _line(diagfmt)
    assert line == _line(jax_diagfmt)
    parsed = diagfmt.parse_diag(line)
    assert parsed == jax_diagfmt.parse_diag(line)
    assert parsed["replay"]["family"] in ("storm", "gangs")
    assert parsed["e2e_p99_ms"] == 87.0
    text = "noise\n" + line + "\nmore\n" + line.replace("storm", "gangs")
    assert diagfmt.parse_diag_lines(text) \
        == jax_diagfmt.parse_diag_lines(text)
    assert diagfmt.parse_diag("no marker here") is None


LEGACY = ("    diag: solve.commit=4.32s/8~p99 540ms encode=1.00s/3 "
          "session[hits=5 rebuilds=2] chunk=512 max_cycle=0.46s "
          "pad_warms=3 tracer=on e2e_buckets[<=0.1:3 <=1.0:9]")


def test_legacy_diag_parse_matches_reference():
    assert diagfmt.parse_diag(LEGACY) == jax_diagfmt.parse_diag(LEGACY)


# ---------------------------------------------------------------------------
# the SLO engine's live tick


def test_slo_engine_start_ticks_and_stop_joins():
    engine = SLOEngine()
    ticks = []
    real = engine.evaluate

    def counted(*a, **kw):
        ticks.append(time.monotonic())
        return real(*a, **kw)

    engine.evaluate = counted
    engine.start(interval_s=0.02)
    first = engine._thread
    engine.start(interval_s=0.02)       # running: a second start is a no-op
    assert engine._thread is first and first.is_alive()
    deadline = time.monotonic() + 5.0
    while len(ticks) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(ticks) >= 3
    engine.stop()
    assert engine._thread is None and not first.is_alive()
    n = len(ticks)
    time.sleep(0.1)
    assert len(ticks) == n
    names = [t.name for t in threading.enumerate()]
    assert first.name not in names or not first.is_alive()
    engine.start(interval_s=0.02)       # restartable
    assert engine._thread is not first and engine._thread.is_alive()
    engine.stop()


# ---------------------------------------------------------------------------
# mini replays on the CPU


@pytest.mark.parametrize("family", FAMILIES)
def test_mini_store_direct_cell_holds_invariants(family):
    stats, extras = run_replay_once(family, 11, 0.15, 0.3, rest=False,
                                    max_batch=256, wait_timeout=120.0,
                                    device="cpu")
    verdicts = replay_bench.family_verdicts(REPLAY_FAMILIES[family], stats)
    assert all(verdicts.values()), (verdicts, stats)
    assert stats.lost == 0 and stats.gangs_partial == 0
    assert stats.priority_inversions == 0
    assert stats.ever_bound > 0 and stats.injected == stats.expected
    assert extras["device"] == "cpu" and extras["solves"] > 0
    if family == "storm":
        assert stats.preempted > 0     # the storm storms
    else:
        assert stats.expired > 0       # lifetimes recycle capacity
    if family == "tenancy":
        assert extras["autoscaler"]["scaleup_decisions"] > 0
        assert stats.arrival_to_bind["serve"]["count"] > 0
    if family == "gangs":
        assert stats.mean_gang_adjacency is not None


def test_mini_storm_over_rest_fabric():
    row = run_replay_row("storm", seed=11, scale=0.08, time_scale=0.2,
                         rest=True, max_batch=256, wait_timeout=180.0,
                         device="cpu")
    assert row["invariants_ok"], row["invariants"]
    assert row["lost_pods"] == 0
    assert row["preempted"] > 0
    assert row["gangs"]["partial"] == 0
    assert "slo" in (row.get("freshness") or {})
    assert row["metric"].startswith("replay_storm[")
    assert row.get("federation_instances")
    assert row["server"]["pods_bound"] == row["server"]["pods_total"]
    assert not row["server"]["import_torch"]
    assert row["device"] == "cpu"
