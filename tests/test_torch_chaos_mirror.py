"""The mirror's chaos cells (``harness/chaos_mirror.py``) and
``bench.py``'s mirror A/B against the JAX package's: the scenario table
and the storm's sizes; each scenario's two arms bit-identical on the
CPU; where both packages drain the same batches (event_storm, and
mesh_resize, whose waves are pumped to the end between the faults) the
port's mirror-on placements equal the JAX cell's; node_kill, whose
in-flight delete lands where the JAX session's timing puts it, is held
to the JAX cell's verdict, counts and mirror counters. The session
keeps the delta journal it attached, and the A/B's gates read its
sustained rows' devprof fields."""

import jax
import pytest

from kubernetes_tpu.harness import chaos_mirror as jax_mirror
from kubernetes_tpu_torch.harness import chaos_mirror

SEEDS = (11, 23)


def test_scenarios_and_storm_sizes_match_the_reference():
    assert chaos_mirror.MIRROR_SCENARIOS == jax_mirror.MIRROR_SCENARIOS
    assert chaos_mirror.STORM_RING_CAP == jax_mirror.STORM_RING_CAP
    assert chaos_mirror.STORM_UPDATES == jax_mirror.STORM_UPDATES
    # the JAX cell's widths on a host of four devices or more (the test
    # configuration gives JAX eight)
    assert len(jax.devices()) >= 4
    assert chaos_mirror.RESIZE_WIDTHS == (2, 4)


def _jax_arm(scenario, seed, monkeypatch):
    monkeypatch.setenv("KTPU_MIRROR", "on")
    return jax_mirror._drive(scenario, seed, True, nodes=20, pods=120,
                             wait_timeout=60.0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scenario", ["event_storm", "mesh_resize"])
def test_placements_equal_the_reference(scenario, seed, monkeypatch):
    port = chaos_mirror._drive(scenario, seed, True, nodes=20, pods=120,
                               wait_timeout=60.0, device="cpu")
    ref = _jax_arm(scenario, seed, monkeypatch)
    assert port["bound"] == [tuple(b) for b in ref["bound"]]
    assert (port["created"], port["deleted"]) == (ref["created"],
                                                  ref["deleted"])
    for k in ("events", "catch_ups", "reseeds"):
        assert port["mirror"][k] == ref["mirror"][k], k


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scenario", chaos_mirror.MIRROR_SCENARIOS)
def test_cell_arms_are_bit_identical_on_the_cpu(scenario, seed):
    cell = chaos_mirror.run_chaos_mirror(seed, scenario=scenario,
                                         device="cpu")
    assert cell["ok"], cell
    assert cell["differential_match"] and cell["lost_pods"] == 0
    st = cell["stats"]
    assert st["events"] > 0
    if scenario == "event_storm":
        assert st["reseeds"] >= 1
    if scenario == "mesh_resize":
        assert st["widths"] == [2, 4]
    assert cell["device"] == "cpu"


@pytest.mark.parametrize("seed", SEEDS)
def test_node_kill_verdict_matches_the_reference(seed, monkeypatch):
    """The node dies while a dispatched solve waits: which batch the
    suspect discard catches follows each session's timing, so the
    verdict, the counts and the mirror's counters are compared, not the
    placements."""
    port = chaos_mirror.run_chaos_mirror(seed, scenario="node_kill",
                                         device="cpu")
    monkeypatch.setenv("KTPU_MIRROR", "on")
    ref = jax_mirror.run_chaos_mirror(seed, scenario="node_kill")
    assert port["ok"] == ref["ok"] is True
    assert port["differential_match"] == ref["differential_match"]
    assert port["lost_pods"] == ref["lost_pods"] == 0
    for k in ("faults_injected", "events", "catch_ups", "reseeds"):
        assert port["stats"][k] == ref["stats"][k], k


def test_event_storm_fails_without_a_journal(monkeypatch):
    """The port's storm cell refuses to run quietly: a mirror-on session
    that attached no journal fails the arm (the JAX cell skips the
    shrink)."""
    from kubernetes_tpu_torch.ops.session import SolverSession

    monkeypatch.setattr(SolverSession, "journal", property(lambda s: None))
    with pytest.raises(RuntimeError, match="no delta journal"):
        chaos_mirror.run_chaos_mirror(11, scenario="event_storm",
                                      device="cpu")


def test_session_keeps_the_journal_it_attached():
    from kubernetes_tpu_torch.apiserver.store import ClusterStore

    for mirror in (True, False):
        sched, bs = chaos_mirror._make_sched(ClusterStore(), device="cpu",
                                             mirror=mirror)
        try:
            journal = bs.session.journal
            if mirror:
                assert journal is not None
                assert sched.cache._journal is journal
                assert bs.session.mirror._journal is journal
            else:
                assert journal is None and bs.session.mirror is None
        finally:
            sched.stop()


def test_unknown_scenario_raises():
    with pytest.raises(ValueError, match="unknown mirror scenario"):
        chaos_mirror.run_chaos_mirror(11, scenario="meteor", device="cpu")


def test_mirror_ab_rows_and_gates_on_the_cpu():
    """A small A/B (600 pods at 400/s, batches of 64): bench.py's three
    rows with their fields, every gate evaluated, the node_kill cell
    differential; the sustained trace gives the on arm's mirror no event
    to scatter."""
    small = dict(pods=600, qps=400.0, node_cpu=16, max_batch=64,
                 wait_timeout=120.0)
    on, off, summary = chaos_mirror.run_mirror_ab(device="cpu", **small)
    assert on["mirror_arm"] == "on" and off["mirror_arm"] == "off"
    assert on["metric"].startswith("mirror_sustained[arm=on, ")
    assert summary["metric"].startswith("mirror_ab[sustained 600pods @ 400/s")
    for row in (on, off):
        t = row["telemetry"]
        assert row["cycles"] == t["cycles"] > 0
        assert row["h2d_per_cycle_bytes"] == round(t["h2d_bytes"]
                                                   / t["cycles"])
        assert row["encode_share"] == t["encode_share"]
        assert row["invariants_ok"] and row["lost_pods"] == 0
    assert on["mirror"] is not None and off["mirror"] is None
    assert on["mirror"]["events"] == 0
    assert on["reseeds_allowed"] == 1 and on["encode_share_budget"] == 0.05
    assert set(summary["gates"]) == {"encode_share", "reseeds", "p99",
                                     "invariants", "differential", "h2d"}
    assert summary["gates"]["differential"] and summary["gates"]["invariants"]
    assert summary["gates"]["encode_share"] and summary["gates"]["reseeds"]
    assert summary["gates"]["h2d"] == (
        summary["h2d_per_cycle_on_bytes"]
        <= 1.10 * summary["h2d_per_cycle_off_bytes"])
    assert summary["cell"]["profile"] == "node_kill"
    assert summary["cell"]["seed"] == 14
    assert summary["cell"]["stats"]["events"] > 0
