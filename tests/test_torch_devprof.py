"""The port's device profiler against the JAX package's: ``summary()``
has the JAX package's keys (and ``device_s``, the launches' timing-event
seconds); the same batch sequence gives the same cycle counts, pad
occupancy, wait and overlap shares, bytes and slowest cycle; a harness
row gives the same cycle count and pad waste as the JAX harness; a first
launch faked inside a measured cycle (the real ``SolveKernel.launch``
with a stand-in library) is an unexpected compile, one inside a warm-up
is a warm compile, one outside any cycle a background compile; so is the
pinned staging ring's first allocation of a capacity.
Tolerance: counts exact, seconds and shares to 1e-9."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.harness import perf as jax_perf
from kubernetes_tpu.harness import workloads as jax_workloads
from kubernetes_tpu.observability import devprof as jax_devprof
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.harness.problems import random_planes
from kubernetes_tpu_torch.metrics.registry import MetricsRegistry
from kubernetes_tpu_torch.metrics.solver_metrics import solver_metrics
from kubernetes_tpu_torch.observability import devprof
from kubernetes_tpu_torch.observability import tracer as tracer_mod
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.solver import SolverParams


@pytest.fixture
def prof(monkeypatch, tmp_path):
    """A fresh process profiler, and a process tracer that dumps under
    ``tmp_path``."""
    p = devprof.DevProfiler(enabled=True)
    monkeypatch.setattr(devprof, "_default", p)
    monkeypatch.setattr(tracer_mod, "_default", tracer_mod.Tracer(
        registry=MetricsRegistry(), dump_dir=str(tmp_path)))
    return p


def _sequence(seed):
    """Seeded cycles: (pad, real, warming, lazy, phases, bytes, block,
    gap before the block)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        pad = int(rng.choice([128, 256, 512]))
        out.append((pad, int(rng.integers(1, pad + 1)), bool(i % 9 == 0),
                    bool(rng.random() < 0.7),
                    {k: float(rng.uniform(0, 0.01)) for k in
                     ("encode", "pack", "scatter", "dispatch")},
                    int(rng.integers(0, 10000)), float(rng.uniform(0, 0.02)),
                    float(rng.uniform(0, 0.05)), float(rng.uniform(0, 0.3))))
    return out


def _drive(p, seq):
    clock = [100.0]
    for i, (pad, real, warming, lazy, phases, nbytes, block, gap,
            stale) in enumerate(seq):
        rec = p.begin_cycle(cycle=i, pad=pad, real=real, warming=warming)
        p.note_staleness(rec, stale)
        for name, s in phases.items():
            p.phase(name, s)
        p.add_bytes("h2d", nbytes)
        p.add_bytes("scatter", nbytes // 4)
        p.end_cycle(rec, pending_block=lazy)
        if lazy:
            rec.dispatch_end = clock[0]
            p.note_block(rec, block, d2h_bytes=4 * real,
                         start_mono=clock[0] + gap)
        else:
            # an eager cycle's wait and readback
            rec.done = False
            rec["block_s"] += block
            rec["d2h_bytes"] += 4 * real
            p._complete(rec)


def test_summary_keys_are_the_reference_s_and_device_s():
    ref = jax_devprof.DevProfiler(enabled=True, use_listener=False)
    port = devprof.DevProfiler(enabled=True)
    assert set(port.summary()) - set(ref.summary()) == {"device_s"}
    assert set(ref.summary()) <= set(port.summary())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_sequence_same_summary(seed, monkeypatch):
    ref = jax_devprof.DevProfiler(enabled=True, use_listener=False)
    ref.listener_active = True   # no timing heuristic: compiles as told
    port = devprof.DevProfiler(enabled=True)
    seq = _sequence(seed)
    _drive(ref, seq)
    _drive(port, seq)
    want, got = ref.summary(), port.summary()
    assert got["compile_detector"] == "cuda"
    for key in want:
        if key != "compile_detector":
            assert got[key] == pytest.approx(want[key], abs=1e-9), key
    assert len(port.cycles()) == len(ref.cycles())
    assert len(port.cycles(include_warming=True)) == len(
        ref.cycles(include_warming=True))


def test_row_cycles_and_pad_waste_equal_the_reference():
    name, nodes, pods, max_batch = "SchedulingBasic", 200, 600, 128
    jax_perf.run_workload(
        name, jax_workloads.make_workload(name, nodes, 0, pods),
        use_batch=True, backend_factory=XlaPlanesBackend,
        adaptive_chunk=False, max_batch=max_batch)
    want = jax_devprof.get_devprof().summary()
    res = perf.run_workload(name, workloads.make_workload(name, nodes, 0,
                                                          pods),
                            device="cpu", max_batch=max_batch)
    got = res.telemetry
    assert got["cycles"] == want["cycles"] > 0
    assert got["pad_waste_pct"] == want["pad_waste_pct"]
    assert got["unexpected_compiles"] == 0
    assert got["overlapped_cycles"] == want["overlapped_cycles"]
    assert got["d2h_bytes"] == 4 * sum(
        c["pad"] for c in devprof.get_devprof().cycles())
    # the default head sampling: about one pod in 64
    assert 0 < res.critical_path["pods"] < pods
    assert res.freshness["slo"]["schedule_latency"] == "ok"


class _FakeLib:
    """The kernels' library, standing in on the CPU: every launch
    succeeds and does nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


def _fake_kernel(monkeypatch):
    kernel = solve_mod.SolveKernel()
    kernel._lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {
                            "cuda_stream": 0})())
    ps, state, ints, floats = random_planes(0, 128, 16)
    plan = solve_mod.plan_launch(128, ps.r, ps.sc, ps.t, ps.u)
    return kernel, (SolverParams(), ps, state, ints, floats, plan)


def test_first_launch_inside_a_measured_cycle_is_unexpected(prof,
                                                            monkeypatch):
    kernel, args = _fake_kernel(monkeypatch)
    before = solver_metrics().unexpected_compiles_total.get()
    rec = prof.begin_cycle(cycle=3, pad=16, real=12)
    kernel.launch(*args)
    kernel.launch(*args)   # the instance is loaded: no second compile
    prof.end_cycle(rec)
    assert [w for w, _ in kernel.compiles] == ["first launch cluster"]
    assert kernel.counts["cluster"] == 2
    assert prof.unexpected_compiles == 1 and prof.warm_compiles == 0
    assert prof.summary()["compiles"] == 1
    assert solver_metrics().unexpected_compiles_total.get() == before + 1
    assert solver_metrics().compiles_total.get("16") >= 1
    assert tracer_mod.get_tracer().last_dump_path is not None


def test_first_launch_in_a_warm_up_and_outside_a_cycle(prof, monkeypatch):
    kernel, args = _fake_kernel(monkeypatch)
    rec = prof.begin_cycle(cycle=-1, pad=16, real=8, warming=True)
    kernel.launch(*args)
    prof.end_cycle(rec)
    assert prof.warm_compiles == 1 and prof.unexpected_compiles == 0
    ps = args[1]
    kernel.launched.clear()
    kernel.launch(*args)   # no cycle open
    assert prof.background_compiles == 1
    assert prof.summary()["cycles"] == 0
    assert ps.sv == 0 and kernel.counts["cluster"] == 2


def test_a_staging_capacity_s_first_allocation_is_a_compile(prof,
                                                            monkeypatch):
    """The pinned ring's first allocation of a capacity is booked like a
    first launch: warm inside a warm-up, unexpected inside a measured
    cycle, background outside any. A smaller pad or another column count
    takes a view of a buffer the ring holds and allocates nothing
    (pinned memory stood in for by plain memory: no card here)."""
    empty = torch.empty
    monkeypatch.setattr(solve_mod.torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    ring = solve_mod.PinnedRing(depth=2)
    rec = prof.begin_cycle(cycle=-1, pad=4096, real=8, warming=True)
    view, slot = ring.take((4096, 23), torch.int32)
    ring.take((4096, 0), torch.float32)
    ring.take((4096,), torch.int32, readback=True)
    prof.end_cycle(rec)
    assert view.shape == (4096, 23) and view.dtype == torch.int32
    assert view.data_ptr() == slot[0].data_ptr()
    rec = prof.begin_cycle(cycle=1, pad=512, real=400)
    for cols in (23, 38, 12):   # another pad, other term counts
        ring.take((512, cols), torch.int32)
        ring.take((512,), torch.int32, readback=True)
    prof.end_cycle(rec)
    assert prof.warm_compiles == 2 and prof.unexpected_compiles == 0
    rec = prof.begin_cycle(cycle=2, pad=4096, real=4000)
    ring.take((4096, 100), torch.int32)   # past the smallest capacity
    prof.end_cycle(rec)
    assert prof.unexpected_compiles == 1
    small = solve_mod.MIN_STAGING_BYTES
    assert [cap for cap, _ in ring.allocations] == [small, small, 2 * small]
    ring.clear()
    ring.take((64,), torch.int64)   # no cycle open
    assert prof.background_compiles == 1 and len(ring.allocations) == 4


def test_aborted_cycle_and_disabled_profiler(prof):
    rec = prof.begin_cycle(cycle=1, pad=64, real=10)
    prof.abort(rec)
    prof.on_compile(1.0)
    assert prof.background_compiles == 1 and rec["compiles"] == 0
    assert prof.cycles(include_warming=True) == []
    off = devprof.DevProfiler(enabled=False)
    assert off.begin_cycle(cycle=1, pad=8, real=8) is None
    assert off.summary()["cycles"] == 0


def test_telemetry_stream_writes_one_record_a_cycle(tmp_path):
    p = devprof.DevProfiler(enabled=True, telemetry_dir=str(tmp_path))
    for i in range(3):
        rec = p.begin_cycle(cycle=i, pad=8, real=4, warming=True)
        p.end_cycle(rec)
    p.close()
    (path,) = tmp_path.iterdir()
    assert len(path.read_text().splitlines()) == 3
