"""Load-aware rebalancing of partitions: the planner and its control loop.

The cluster autoscaler buys and retires nodes; this module applies the
same discipline a level up, to partitions of write load (apiserver
partitions in the reference package, clusters in ``federation.
rebalancer``). The decision is a pure function (``plan_rebalance``) of
one tick's per-slot and per-namespace write rates, the topology and the
liveness:

- a dead partition -> **failover**;
- one namespace dominating the writes -> **split** it;
- a hot partition with movable slots -> **move** its hottest slots to
  the coldest partition;
- the whole fleet hot with nothing to move -> **buy** a partition;
- a near-idle fleet -> **retire** the least-loaded partition.

``PartitionRebalancer`` observes, plans and acts through a driver, each
action bounded by the group's cooldown so a noisy signal cannot thrash.
The drivers of an apiserver fleet wait for the port's REST fabric; the
federation's driver is in ``federation.rebalancer``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.metrics.autoscaler_metrics import (
    autoscaler_metrics,
)

_logger = logging.getLogger(__name__)


@dataclass
class PartitionGroup:
    """Scaling bounds for the partitions: the node group's contract
    (min, max, cooldown) applied to them."""

    name: str = "control-plane"
    min_partitions: int = 1
    max_partitions: int = 8
    cooldown_s: float = 3.0


@dataclass
class RebalancePolicy:
    """Thresholds of the planner."""

    imbalance_threshold: float = 1.6   # max/mean rate before acting
    spread_share: float = 0.45         # one namespace above it -> split
    min_rate: float = 20.0             # writes a tick to bother at all
    sustain_ticks: int = 2             # consecutive hot ticks to act
    move_headroom: float = 1.1         # move until hot <= headroom * mean
    max_moves: int = 8                 # slots a move
    buy_rate: float = 400.0            # mean rate a partition: saturated
    buy_floor_share: float = 0.6       # coldest >= this share of the mean
    retire_rate: float = 2.0           # rate a partition that reads idle


def plan_rebalance(slot_rates: Dict[int, float],
                   ns_rates: Dict[str, float],
                   topology,
                   dead: List[int],
                   policy: RebalancePolicy,
                   group: PartitionGroup) -> Optional[Dict[str, Any]]:
    """One decision from one tick's observations, or None. Failover comes
    first (a silent partition is worse than a hot one), then split, move
    and buy, cheapest first."""
    if dead:
        return {"op": "failover", "partition": dead[0]}
    live = [p for p in range(topology.partitions)
            if p not in topology.retired and p not in dead]
    if not live:
        return None
    rates = {p: 0.0 for p in live}
    for slot, rate in slot_rates.items():
        owner = topology.owner[slot]
        if owner in rates:
            rates[owner] += rate
    total = sum(rates.values())
    if total < policy.min_rate:
        # an idle fleet folds back to its floor
        if len(live) > group.min_partitions \
                and total < policy.retire_rate * len(live):
            coldest = min(live, key=lambda p: rates[p])
            if topology.slots_of_partition(coldest):
                return {"op": "retire", "partition": coldest}
        return None
    mean = total / len(live)
    hot = max(live, key=lambda p: rates[p])
    coldest = min(live, key=lambda p: rates[p])
    imbalance = rates[hot] / mean if mean > 0 else 0.0
    if imbalance >= policy.imbalance_threshold:
        # split: one tenant dominating the writes
        if ns_rates:
            hot_ns = max(ns_rates, key=ns_rates.get)
            ns_total = sum(ns_rates.values())
            if ns_total > 0 \
                    and ns_rates[hot_ns] / ns_total >= policy.spread_share \
                    and hot_ns not in topology.spread:
                return {"op": "split", "namespace": hot_ns}
        # move: the hot partition's hottest slots to the coldest
        movable = sorted(
            (s for s in topology.slots_of_partition(hot)
             if slot_rates.get(s, 0.0) > 0),
            key=lambda s: slot_rates.get(s, 0.0), reverse=True)
        assignments: Dict[int, int] = {}
        projected_hot = rates[hot]
        for s in movable:
            if projected_hot <= policy.move_headroom * mean \
                    or len(assignments) >= policy.max_moves:
                break
            rate = slot_rates.get(s, 0.0)
            if rate >= rates[hot] * 0.9 and len(movable) > 1:
                # one slot is the hotspot: moving it moves the problem
                continue
            assignments[s] = coldest
            projected_hot -= rate
        if assignments:
            return {"op": "move", "assignments": assignments}
    # buy: every partition busy and nothing left to move
    if len(live) < group.max_partitions \
            and mean >= policy.buy_rate \
            and rates[coldest] >= policy.buy_floor_share * mean:
        return {"op": "buy"}
    return None


class PartitionRebalancer:
    """The loop: observe the driver's ledgers, plan (pure), act through
    the driver. A driver has ``observe() -> {"epoch", "topology",
    "slot_writes", "ns_writes", "dead"}`` (cumulative write counters),
    ``federate()`` and ``apply(action) -> report``. Runs as a plain
    thread (``run``), or a tick at a time (``tick``)."""

    def __init__(self, driver, group: Optional[PartitionGroup] = None,
                 policy: Optional[RebalancePolicy] = None,
                 interval_s: float = 0.5):
        self.driver = driver
        self.group = group or PartitionGroup()
        self.policy = policy or RebalancePolicy()
        self.interval_s = float(interval_s)
        self.actions: List[dict] = []
        self._last: Optional[dict] = None
        self._hot_ticks = 0
        self._last_action_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def tick(self) -> Optional[dict]:
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> Optional[dict]:
        try:
            obs = self.driver.observe()
        except Exception as e:  # noqa: BLE001 — a dead fleet keeps ticking
            _logger.warning("rebalancer observe failed: %s", e)
            return None
        try:
            self.driver.federate()
        except Exception:  # noqa: BLE001 — metrics must not block acts
            pass
        last = self._last
        self._last = obs
        if last is None:
            return None
        # rates a tick: deltas of cumulative ledgers (a failover resets
        # them, so clamp at zero)
        slot_rates = {s: max(0.0, obs["slot_writes"].get(s, 0)
                             - last["slot_writes"].get(s, 0))
                      for s in obs["slot_writes"]}
        ns_rates = {n: max(0.0, obs["ns_writes"].get(n, 0)
                           - last["ns_writes"].get(n, 0))
                    for n in obs["ns_writes"]}
        action = plan_rebalance(slot_rates, ns_rates, obs["topology"],
                                obs["dead"], self.policy, self.group)
        if action is None:
            self._hot_ticks = 0
            return None
        if action["op"] != "failover":
            self._hot_ticks += 1
            if self._hot_ticks < self.policy.sustain_ticks:
                return None
            if time.monotonic() - self._last_action_at \
                    < self.group.cooldown_s:
                return None
        try:
            report = self.driver.apply(action)
        except Exception as e:  # noqa: BLE001 — retried next tick
            _logger.warning("rebalance %s failed: %s", action, e)
            return None
        self._hot_ticks = 0
        self._last_action_at = time.monotonic()
        done = {"action": action, "report": report, "at": time.monotonic()}
        self.actions.append(done)
        m = autoscaler_metrics()
        if action["op"] == "buy":
            m.scaleups_total.inc(self.group.name, "rebalancer")
        elif action["op"] == "retire":
            m.scaledowns_total.inc(self.group.name)
        return done

    def run(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="partition-rebalancer")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                _logger.exception("rebalancer tick failed")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
