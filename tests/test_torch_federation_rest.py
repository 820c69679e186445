"""The port's federation storm over the REST fabric against the JAX
package's, on the CPU.

- ``_federation_ok`` flips on each invariant alone exactly as the JAX
  function does (the base result of the JAX package's verdict test);
- ``run_federation_row`` and ``run_chaos_federation`` shape the same row
  and verdict from the same storm result (the storm stood in for on both
  sides); the port's row adds ``device`` and ``children_import_torch``;
- both packages' storms refuse an unknown scenario before spawning;
- one compressed storm per mode over three spawned cells, the cells'
  batch paths on the CPU: every verdict the row gates holds.

Tolerance: exact equality.
"""

import pytest

from kubernetes_tpu.harness import federation as jax_fed
from kubernetes_tpu_torch.harness import federation as port_fed

BASE = {"scenario": "spill-loss", "lost_pods": 0, "injected": 10,
        "ever_bound": 10, "send_errors": [], "gang_splits": 0,
        "survivor_relists": 0, "per_cluster_slo_ok": True,
        "recovery_ratio": 1.0, "victim": 1, "slo_verdicts_ok": True,
        "spilled": 3, "failovers": 1}

FLIPS = {"clean": {}, "lost_pods": {"lost_pods": 2},
         "all_bound": {"ever_bound": 9},
         "send_errors": {"send_errors": ["boom"]},
         "gangs_atomic": {"gang_splits": 1},
         "relist_confinement": {"survivor_relists": 4},
         "per_cluster_slo": {"per_cluster_slo_ok": False},
         "recovery": {"recovery_ratio": 0.5},
         "recovery_floor": {"recovery_ratio": 0.8},
         "slo": {"slo_verdicts_ok": False},
         "slo_unknown": {"slo_verdicts_ok": None},
         "spilled": {"spilled": 0}, "failed_over": {"failovers": 0},
         "no_victim": {"victim": None, "failovers": 0,
                       "recovery_ratio": 0.0},
         "loss_no_spill": {"scenario": "loss-mid", "spilled": 0},
         "nothing_injected": {"injected": 0, "ever_bound": 0}}


@pytest.mark.parametrize("case", sorted(FLIPS))
def test_verdict_flips_like_the_reference(case):
    res = dict(BASE, **FLIPS[case])
    got = port_fed._federation_ok(dict(res))
    assert got == jax_fed._federation_ok(dict(res))
    passing = {"clean", "recovery_floor", "slo_unknown", "no_victim",
               "loss_no_spill"}
    assert got[0] == (case in passing), got
    if not got[0] and case in ("all_bound", "spilled", "failed_over"):
        assert got[1] == case


def _storm_result(victim):
    return {
        "scenario": "loss-mid" if victim is not None else "spill",
        "seed": 18, "device": "cpu", "clusters": 3, "qps": 300.0,
        "injected": 900, "ever_bound": 900, "server_bound": 870,
        "lost_pods": 0, "send_errors": [], "p99_arrival_to_bind_ms": 412,
        "p50_arrival_to_bind_ms": 37, "last_bind_s": 3.4,
        "offered_rate": 299.6,
        "per_cluster": {"c0": {"bound": 200, "p99_ms": 311.0},
                        "c1": {"bound": 350, "p99_ms": 402.5},
                        "c2": {"bound": 350, "p99_ms": 388.0}},
        "per_cluster_slo_ok": True, "gangs_total": 22, "gang_splits": 0,
        "spilled": 0 if victim is not None else 131,
        "fallback_placements": 1, "failovers": int(victim is not None),
        "failover_replaced": 97 if victim is not None else 0,
        "victim": victim, "orphans": 110, "orphans_unbound_at_kill": 41,
        "recovered_in_budget": 41, "recovery_budget_s": 30.0,
        "recovery_ratio": 1.0, "survivor_relists": 0,
        "rebalancer_actions": ["failover"] if victim is not None else [],
        "children_import_torch": False,
        "freshness": {"slo": {"watch_delivery": "ok"}},
        "slo_verdicts_ok": True,
        "critical_path": {"unattributed_share": 0.01, "per_pod": []},
    }


@pytest.mark.parametrize("mode", ["spill", "loss"])
def test_row_and_chaos_verdict_shape_like_the_reference(monkeypatch, mode):
    victim = 1 if mode == "loss" else None
    for mod in (jax_fed, port_fed):
        monkeypatch.setattr(mod, "run_federation_storm",
                            lambda **kw: dict(_storm_result(victim)))
    ref = jax_fed.run_federation_row(mode=mode)
    got = port_fed.run_federation_row(mode=mode, device="cpu")
    assert got.pop("device") == "cpu"
    assert got.pop("children_import_torch") is False
    assert got == ref
    assert got["invariants_ok"] is True
    scenario = "loss-mid" if mode == "loss" else "spill"
    assert port_fed.run_chaos_federation(18, scenario=scenario,
                                         device="cpu") == \
        jax_fed.run_chaos_federation(18, scenario=scenario)


@pytest.mark.parametrize("fn", ["run_federation_storm", "row",
                                "run_chaos_federation"])
def test_unknown_scenario_is_refused(fn):
    calls = {
        "run_federation_storm": lambda m: m.run_federation_storm(
            scenario="bogus"),
        "row": lambda m: m.run_federation_row(mode="bogus"),
        "run_chaos_federation": lambda m: m.run_chaos_federation(
            18, scenario="bogus"),
    }
    for mod in (jax_fed, port_fed):
        with pytest.raises(ValueError, match="unknown federation"):
            calls[fn](mod)


@pytest.fixture(scope="module", params=["spill", "loss"])
def storm_row(request):
    return port_fed.run_federation_row(
        pods=120, qps=80.0, mode=request.param, max_batch=64,
        wait_timeout=60, device="cpu")


def test_compressed_storm_holds_every_verdict(storm_row):
    row = storm_row
    assert row["invariants_ok"], row["invariants"]
    assert row["lost_pods"] == 0
    assert row["ever_bound"] == row["injected"] == 120
    assert row["gang_splits"] == 0
    assert row["survivor_relists"] == 0
    assert row["device"] == "cpu"
    assert row["children_import_torch"] is False
    if row["metric"].startswith("federation_loss"):
        assert row["failovers"] >= 1
        assert row["recovery_ratio"] >= port_fed.RECOVERY_RATIO_FLOOR
    else:
        assert row["spilled"] > 0
