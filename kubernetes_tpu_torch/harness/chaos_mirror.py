"""Seeded chaos cells for the device-resident cluster mirror, and
``bench.py --config mirrorab`` (``run_mirror_ab``).

Every cell runs the same seeded event sequence twice, mirror on (the
journal's deltas scattered into the resident planes with ``index_put_``)
and mirror off (the delta-encode reference), and passes only when the
two arms bind a bit-identical placement set with zero lost pods. The
scenarios aim the faults at the mirror's seams:

- ``node_kill``: a node dies inside the scatter window: a solve is
  dispatched and still in flight when the node is deleted, so the
  suspect-batch discard and the node-set epoch bump both cross the
  resident planes mid-sequence.
- ``mesh_resize``: the sharded backend is torn down and attached again
  at another width with pods in flight: the new session seeds the
  mirror cold from the store and keeps the differential. The widths are
  2 then 4 node shards of one device (``make_mesh``), the JAX cell's
  widths on a host of four or more devices.
- ``event_storm``: a storm of mutations overflows the delta journal's
  ring between two solves: the window reads as a gap, which must show
  as a reseed (a full host encode and the mirror seeded again), never
  as deltas silently missing. The cell fails if the storm forced no
  reseed, and the mirror-on arm fails if its session attached no
  journal to shrink.

The churn sets a node's allocatable cpu to ``Quantity(n)``: n nanocores,
as the JAX cell does, so the node is full while the value stands.

Each arm runs on ``device``: the card unless "cpu" is passed (raises
without one). On the card the batches run the cluster kernel, and
``mesh_resize``'s the sharded kernel.
"""

from __future__ import annotations

import copy
import gc
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

MIRROR_SCENARIOS = ("node_kill", "mesh_resize", "event_storm")

# the ring capacity the event-storm cell shrinks the live journal to:
# small enough that the storm below overflows it between two solves,
# large enough that the cell's quiet phases never gap
STORM_RING_CAP = 96
STORM_UPDATES = 3 * STORM_RING_CAP

# mesh_resize's node-shard widths, before and after the resize
RESIZE_WIDTHS = (2, 4)


def _pump(sched, bs, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sched.queue.flush_backoff_completed()
        if bs.run_batch(pop_timeout=0.0):
            continue
        if sched.queue.pending_active_count() == 0 and \
                bs._pending is None:
            break
        time.sleep(0.01)
    bs.flush()
    sched.wait_for_inflight_bindings()


def _bound_set(store) -> List[Tuple[str, Optional[str]]]:
    return sorted((p.metadata.name, p.spec.node_name)
                  for p in store.list_pods())


def _set_node_cpu(store, name: str, cpu: str) -> None:
    from kubernetes_tpu_torch.api.resource import Quantity

    node = copy.deepcopy(store.get_node(name))
    node.status.allocatable["cpu"] = Quantity(cpu)
    node.status.capacity["cpu"] = Quantity(cpu)
    store.update_node(node)


def _make_sched(store, *, device, mirror: bool, max_batch=64,
                backend=None):
    from kubernetes_tpu_torch.config.feature_gates import FeatureGates
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.sidecar import attach_batch_scheduler

    sched = Scheduler.create(
        store, feature_gates=FeatureGates({"TPUBatchScheduler": True}),
        provider="GangSchedulingProvider")
    bs = attach_batch_scheduler(sched, max_batch=max_batch, device=device,
                                mirror=mirror, adaptive_chunk=False,
                                backend=backend)
    sched.start()
    return sched, bs


def _sharded_backend(width: int, device):
    from kubernetes_tpu_torch.parallel.sharded import (
        ShardedBackend,
        make_mesh,
    )

    return ShardedBackend(make_mesh(width, batch_axis=1, device=device))


def _drive(scenario: str, seed: int, mirror_on: bool, *,
           nodes: int, pods: int, wait_timeout: float, device,
           progress: Optional[Callable[[str], None]] = None) -> Dict:
    """One arm of a cell: drive the seeded sequence and return the final
    placement set, the mirror's counters (None on the off arm), the
    pods created and deleted, and the shard widths used."""
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.testing import MakeNode, MakePod

    if scenario not in MIRROR_SCENARIOS:
        raise ValueError(f"unknown mirror scenario {scenario!r}")
    scheds = []
    try:
        rng = np.random.default_rng(seed)
        store = ClusterStore()
        for i in range(nodes):
            store.add_node(MakeNode().name(f"n{i}")
                           .capacity({"cpu": "8",
                                      "memory": "16Gi"}).obj())
        w0 = max(8, int(pods * 0.4))
        w1 = max(8, int(pods * 0.35))
        w2 = max(4, pods - w0 - w1)
        created = 0
        deleted = 0

        def make_wave(w: int, count: int):
            nonlocal created
            created += count
            return [
                MakePod().name(f"w{w}-p{i}").uid(f"u{w}-{i}")
                .req({"cpu": f"{int(rng.integers(1, 5)) * 100}m"})
                .obj()
                for i in range(count)
            ]

        def churn() -> None:
            # scatterable deltas: allocatable-only node updates and
            # deletions of bound pods; the fault must cross a mirror
            # that has scattered, not one freshly seeded
            nonlocal deleted
            picks = rng.choice(nodes, size=2, replace=False)
            _set_node_cpu(store, f"n{picks[0]}", "6")
            _set_node_cpu(store, f"n{picks[1]}", "10")
            bound = [p for p in store.list_pods() if p.spec.node_name]
            if len(bound) >= 4:
                for p in rng.choice(bound, size=4, replace=False):
                    store.delete_pod(p.metadata.namespace,
                                     p.metadata.name)
                    deleted += 1

        widths: Tuple[Optional[int], ...] = (None, None)
        backend = None
        if scenario == "mesh_resize":
            widths = RESIZE_WIDTHS
            backend = _sharded_backend(widths[0], device)
        sched, bs = _make_sched(store, device=device, mirror=mirror_on,
                                backend=backend)
        scheds.append(sched)

        store.create_pods(make_wave(0, w0))
        _pump(sched, bs, timeout=wait_timeout)

        if scenario == "node_kill":
            # the churned deltas scatter on the next dispatch; the node
            # dies while that solve is still in flight (the scatter
            # window)
            churn()
            store.create_pods(make_wave(1, w1))
            bs.run_batch(pop_timeout=0.1)
            store.delete_node(f"n{int(rng.integers(0, nodes))}")
            _pump(sched, bs, timeout=wait_timeout)
        elif scenario == "event_storm":
            churn()
            store.create_pods(make_wave(1, w1))
            _pump(sched, bs, timeout=wait_timeout)
            journal = bs.session.journal
            if mirror_on:
                if journal is None:
                    raise RuntimeError(
                        "event_storm: the mirror-on session attached no "
                        "delta journal to shrink")
                with journal._lock:
                    journal._recs = deque(journal._recs,
                                          maxlen=STORM_RING_CAP)
            # the storm: allocatable churn far past the ring's capacity
            # between two solves; the next catch-up window must read as
            # a gap, never as "nothing happened"
            for _ in range(STORM_UPDATES):
                pick = int(rng.integers(0, nodes))
                cpu = str(int(rng.choice([6, 8, 10, 12])))
                _set_node_cpu(store, f"n{pick}", cpu)
        else:
            # pods in flight across the resize: a solve dispatched, then
            # the backend torn down and attached again one width up;
            # more churn lands on the mirror seeded again afterwards
            churn()
            store.create_pods(make_wave(1, w1))
            bs.run_batch(pop_timeout=0.1)
            sched.stop()
            sched, bs = _make_sched(
                store, device=device, mirror=mirror_on,
                backend=_sharded_backend(widths[1], device))
            scheds.append(sched)
            _pump(sched, bs, timeout=wait_timeout)
            # a small wave makes sure of a solve after the resize (the
            # mirror seeds at its first solve), so the churn below
            # scatters instead of folding into the cold seed
            store.create_pods(make_wave(3, 8))
            _pump(sched, bs, timeout=wait_timeout)
            churn()

        store.create_pods(make_wave(2, w2))
        _pump(sched, bs, timeout=wait_timeout)

        info = bs.session.mirror.info() \
            if bs.session.mirror is not None else None
        if progress:
            arm = "on" if mirror_on else "off"
            progress(f"[mirror/{scenario}] arm={arm} created={created} "
                     f"mirror={info}")
        return {"bound": _bound_set(store), "mirror": info,
                "created": created, "deleted": deleted,
                "widths": widths}
    finally:
        for s in scheds:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        gc.collect()


def run_chaos_mirror(
    seed: int,
    *,
    scenario: str,
    nodes: int = 20,
    pods: int = 120,
    wait_timeout: float = 120.0,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """One (scenario x seed) cell: both arms on ``device``, and the
    differential verdict."""
    from kubernetes_tpu_torch.device import resolve_device

    if scenario not in MIRROR_SCENARIOS:
        raise ValueError(f"unknown mirror scenario {scenario!r} "
                         f"(have: {', '.join(MIRROR_SCENARIOS)})")
    dev = resolve_device(device)
    t0 = time.monotonic()
    on = _drive(scenario, seed, True, nodes=nodes, pods=pods,
                wait_timeout=wait_timeout, device=dev, progress=progress)
    off = _drive(scenario, seed, False, nodes=nodes, pods=pods,
                 wait_timeout=wait_timeout, device=dev, progress=progress)
    match = on["bound"] == off["bound"]
    lost = ((on["created"] - on["deleted"] - len(on["bound"]))
            + (off["created"] - off["deleted"] - len(off["bound"])))
    info = on["mirror"] or {}
    problems = []
    if on["mirror"] is None:
        problems.append("mirror-on arm built no mirror")
    if off["mirror"] is not None:
        problems.append("mirror-off arm built a mirror")
    if not match:
        problems.append("differential mismatch: mirror-on placements "
                        "diverged from the delta-encode reference")
    if lost:
        problems.append(f"lost_pods={lost}")
    if on["mirror"] is not None and not info.get("events"):
        problems.append("no deltas were ever scattered (the fault "
                        "crossed a mirror the cell never exercised)")
    if scenario == "event_storm" and not info.get("reseeds"):
        problems.append("storm never forced a reseed (the journal-gap "
                        "path went untested: a quiet cell proves "
                        "nothing)")
    return {
        "seed": seed,
        "profile": scenario,
        "ok": not problems,
        "failure": "; ".join(problems),
        "differential_match": match,
        "lost_pods": lost,
        "device": str(dev),
        "stats": {
            "faults_injected": (STORM_UPDATES
                                if scenario == "event_storm" else 1),
            "events": info.get("events"),
            "catch_ups": info.get("catch_ups"),
            "reseeds": info.get("reseeds"),
            "scatter_bytes": info.get("scatter_bytes"),
            "bound": len(on["bound"]),
            "created": on["created"],
            "deleted": on["deleted"],
            "widths": list(on["widths"]),
            "wall_s": time.monotonic() - t0,
        },
    }


# ---------------------------------------------------------------------------
# bench.py --config mirrorab

# the on arm's gates (bench.py's fields, read by its mirror_flags)
ENCODE_SHARE_BUDGET = 0.05
RESEEDS_ALLOWED = 1
P99_BUDGET_MS = 500
# the on arm's h2d bytes a cycle against the off arm's: the reference's
# A/B bar (tools/perf_report.py mirror_flags), headroom for the cycle
# count's noise over identical traces
H2D_ON_OFF_BAR = 1.10


def mirror_arm_row(row: Dict, arm: str) -> Dict:
    """A sustained row as the A/B's arm: ``bench.py``'s fields (the
    encode share and the h2d bytes a cycle from the row's devprof
    telemetry) and, on the on arm, its gates and their verdicts."""
    row = dict(row)
    row["metric"] = (f"mirror_sustained[arm={arm}, "
                     + row["metric"].split("[", 1)[1])
    row["mirror_arm"] = arm
    t = row.get("telemetry") or {}
    row["encode_share"] = t.get("encode_share")
    row["p99_budget_ms"] = P99_BUDGET_MS
    cycles = int(t.get("cycles") or 0)
    row["cycles"] = cycles
    row["h2d_bytes"] = t.get("h2d_bytes")
    if cycles:
        row["h2d_per_cycle_bytes"] = round(
            float(t.get("h2d_bytes", 0)) / cycles)
    if arm == "on":
        row["encode_share_budget"] = ENCODE_SHARE_BUDGET
        # one reseed is structural: the warm-up's session rebuilds when
        # the live trace starts; any further reseed means journal gaps
        # or inexpressible deltas mid-run
        row["reseeds_allowed"] = RESEEDS_ALLOWED
    return row


def run_mirror_ab(*, device=None,
                  progress: Optional[Callable[[str], None]] = None,
                  **sizes) -> List[Dict]:
    """The device mirror's on/off A/B on the sustained row
    (``bench.py --config mirrorab``): both arms over the same seeded
    open-loop trace (seed 14), then the seeded ``node_kill`` cell (seed
    14, both arms bit-identical). Returns ``bench.py``'s rows: the two
    arms, then the summary row, whose ``gates`` and ``ok`` hold the
    verdicts: the on arm's encode share at most 0.05, at most one
    reseed, p99 within 500 ms, every invariant held, the differential
    matched and nothing lost, and the on arm's h2d bytes a cycle at most
    1.10 times the off arm's (the reference's A/B bar; ``bench.py`` held
    the on arm against a committed budget measured on another device,
    and this run's off arm is the bar here). ``h2d_below_off`` reports
    whether the on arm moved strictly fewer bytes a cycle: the
    sustained trace is arrivals only, so the mirror has no delta to
    scatter (the on arm's ``mirror`` counts 0 events) and the arms move
    the same bytes but for the cycle count's noise; the scatter path
    runs in the ``node_kill`` cell only.

    ``sizes`` overrides ``bench.py``'s sizes (``pods`` 30,000, ``qps``
    5,000, ``node_cpu`` 32, ``max_batch`` 4,096, ``wait_timeout`` 900
    s): a small A/B on the CPU."""
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.harness.sustained import run_sustained_row

    dev = resolve_device(device)
    sizes = {"pods": 30_000, "qps": 5000.0, "node_cpu": 32,
             "max_batch": 4096, "wait_timeout": 900, **sizes}
    pods, qps = sizes["pods"], sizes["qps"]
    arms: Dict[str, Dict] = {}
    for arm in ("on", "off"):
        if progress:
            progress(f"[mirror-ab] sustained arm mirror={arm}: "
                     f"{pods} pods @ {qps:.0f}/s")
        row = run_sustained_row(pods=pods, qps=qps,
                                node_cpu=sizes["node_cpu"],
                                max_batch=sizes["max_batch"],
                                mirror=arm == "on", device=dev,
                                wait_timeout=sizes["wait_timeout"],
                                progress=progress)
        arms[arm] = mirror_arm_row(row, arm)
    if progress:
        progress("[mirror-ab] seeded differential cell (node_kill)")
    cell = run_chaos_mirror(14, scenario="node_kill", device=dev,
                            progress=progress)
    on, off = arms["on"], arms["off"]
    overhead_pct = 0.0
    if off["value"] > 0:
        overhead_pct = 100.0 * (1.0 - on["value"] / off["value"])
    reseeds = int((on.get("mirror") or {}).get("reseeds") or 0)
    h2d_on, h2d_off = (on.get("h2d_per_cycle_bytes"),
                       off.get("h2d_per_cycle_bytes"))
    gates = {
        "encode_share": on["encode_share"] is not None
        and on["encode_share"] <= ENCODE_SHARE_BUDGET,
        "reseeds": reseeds <= RESEEDS_ALLOWED,
        "p99": on["p99_arrival_to_bind_ms"] <= P99_BUDGET_MS,
        "invariants": bool(cell["ok"] and on.get("invariants_ok")
                           and off.get("invariants_ok")),
        "differential": bool(cell["differential_match"]
                             and cell["lost_pods"] == 0),
        "h2d": h2d_on is not None and h2d_off is not None
        and h2d_on <= H2D_ON_OFF_BAR * h2d_off,
    }
    summary = {
        "metric": (f"mirror_ab[sustained {pods}pods @ {qps:.0f}/s "
                   f"on/off + seeded node_kill differential]"),
        "value": round(overhead_pct, 2),
        "unit": "%",
        "mirror_on_pods_per_sec": on["value"],
        "mirror_off_pods_per_sec": off["value"],
        "h2d_per_cycle_on_bytes": h2d_on,
        "h2d_per_cycle_off_bytes": h2d_off,
        "encode_share_on": on.get("encode_share"),
        "encode_share_off": off.get("encode_share"),
        "h2d_below_off": h2d_on is not None and h2d_off is not None
        and h2d_on < h2d_off,
        "reseeds_on": reseeds,
        "p99_on_ms": on["p99_arrival_to_bind_ms"],
        "p99_off_ms": off["p99_arrival_to_bind_ms"],
        "differential_match": cell["differential_match"],
        "differential_lost_pods": cell["lost_pods"],
        "invariants_ok": gates["invariants"],
        "cell": cell,
        "gates": gates,
        "ok": all(gates.values()),
        "device": str(dev),
    }
    return [on, off, summary]
