"""The sustained-arrival path on the CPU: the port's trace and fleet
equal the JAX package's for the same seed, and a small open-loop cell
(600 pods at 400 a second, batches of 64) loses no pod in the pipelined
and the serialized arm, with the replay engine's accounting closed."""

import pytest

from kubernetes_tpu.harness import sustained as jax_sustained
from kubernetes_tpu_torch.harness import sustained
from kubernetes_tpu_torch.harness.burst import stream_arrivals


@pytest.mark.parametrize("seed,pods,qps", [(14, 600, 400.0),
                                           (14, 30_000, 5000.0)])
def test_trace_and_nodes_match_reference(seed, pods, qps):
    got = sustained.build_sustained_trace(seed, pods, qps)
    want = jax_sustained.build_sustained_trace(seed, pods, qps)
    assert [(e.t, e.name, e.cpu_milli, e.memory_mib, e.lifetime_s)
            for e in got.events] == [
        (e.t, e.name, e.cpu_milli, e.memory_mib, e.lifetime_s)
        for e in want.events]
    assert got.offered_rate == want.offered_rate
    assert sustained.sustained_nodes(got) == [
        dict(d) for d in jax_sustained.sustained_nodes(want)]


def test_stream_arrivals_sends_everything_in_order_and_chunks():
    sent = []
    n = stream_arrivals(((i * 1e-4, i) for i in range(50)), sent.append,
                        chunk=8, time_scale=0.0)
    assert n == 50 and [x for part in sent for x in part] == list(range(50))
    assert all(len(part) <= 8 for part in sent)


@pytest.mark.parametrize("pipeline", [True, False])
def test_sustained_cell_loses_nothing(pipeline):
    cell = sustained.run_sustained_cell(device="cpu", pipeline=pipeline)
    assert cell["device"] == "cpu"
    assert cell["lost"] == 0
    assert cell["injected"] == cell["expected"] == cell["ever_bound"] == 600
    assert cell["p99_arrival_to_bind_ms"] > 0
    if pipeline:
        assert cell["pipeline"]["depth"] >= 1
        assert cell["mirror"] is not None
    else:
        assert cell["pipeline"] is None
    assert cell["session"]["solves"] >= 600 // 64
