"""Arrival traces: one event per pod, with the offset it arrives at and
its requests, from a seeded generator.

- arrivals are a Poisson process, optionally with burst epochs;
- cpu sizes are bounded-Pareto heavy-tailed, memory proportional to cpu
  with jitter;
- lifetimes, when asked for, are a two-mode lognormal mixture.

``generate_trace`` is a pure function of its seed and parameters: only
``random.Random`` is used, so the same call gives the same events.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from random import Random
from typing import Dict, Iterable, List, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
    GROUP_NAME_LABEL,
    MIN_AVAILABLE_LABEL,
)


def bounded_pareto(rng: Random, alpha: float, lo: float, hi: float) -> float:
    """Bounded Pareto on [lo, hi] by inverse CDF."""
    if hi <= lo:
        return lo
    u = rng.random()
    la, ha = lo ** alpha, hi ** alpha
    return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)


def lognormal_mixture(rng: Random, modes) -> float:
    """A sample of a weighted mixture of lognormals, ``modes`` being
    (weight, mu, sigma) triples."""
    total = sum(w for w, _, _ in modes)
    pick = rng.random() * total
    acc = 0.0
    for w, mu, sigma in modes:
        acc += w
        if pick <= acc:
            return rng.lognormvariate(mu, sigma)
    return rng.lognormvariate(modes[-1][1], modes[-1][2])


def poisson_arrivals(rng: Random, rate: float, duration_s: float,
                     burst_factor: float = 1.0,
                     burst_period_s: float = 0.0) -> List[float]:
    """Arrival offsets on [0, duration_s) with exponential gaps at
    ``rate`` a second; with bursts, the first half of every
    ``burst_period_s`` runs ``burst_factor`` times the second half's
    rate, the mean staying ``rate``."""
    out: List[float] = []
    t = 0.0
    while True:
        if burst_period_s > 0 and burst_factor > 1.0:
            phase = math.fmod(t, burst_period_s)
            hi = 2.0 * rate * burst_factor / (burst_factor + 1.0)
            lo = 2.0 * rate / (burst_factor + 1.0)
            r = hi if phase < burst_period_s / 2.0 else lo
        else:
            r = rate
        t += rng.expovariate(r)
        if t >= duration_s:
            return out
        out.append(t)


def arrivals_exactly(rng: Random, count: int, span_s: float,
                     burst_factor: float = 1.0,
                     burst_period_s: float = 0.0) -> List[float]:
    """Exactly ``count`` sorted arrival offsets on [0, span_s): a Poisson
    draw at the matching rate, cut or topped up with uniform draws."""
    rate = count / span_s if span_s > 0 else float(count)
    ts = poisson_arrivals(rng, rate, span_s, burst_factor=burst_factor,
                          burst_period_s=burst_period_s)
    while len(ts) < count:
        ts.append(rng.random() * span_s)
    return sorted(ts[:count])


@dataclass
class TraceEvent:
    """One pod arrival ``t`` seconds after the trace starts. A bound pod
    runs ``lifetime_s`` seconds before it is deleted (None: forever).
    ``gang`` and ``gang_size`` make the pod a member of a coscheduled
    gang: ``pod_dict`` stamps the ``pod-group.scheduling.k8s.io``
    labels."""

    t: float
    name: str
    cpu_milli: int
    memory_mib: int
    priority: int = 0
    lifetime_s: Optional[float] = None
    gang: str = ""
    gang_size: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    namespace: str = "default"

    def to_dict(self) -> dict:
        """The event as a dict, fields at their defaults left out."""
        d = asdict(self)
        for k, default in (("priority", 0), ("lifetime_s", None),
                           ("gang", ""), ("gang_size", 0), ("labels", {}),
                           ("namespace", "default")):
            if d[k] == default:
                del d[k]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(
            t=float(d["t"]), name=d["name"],
            cpu_milli=int(d["cpu_milli"]),
            memory_mib=int(d["memory_mib"]),
            priority=int(d.get("priority", 0)),
            lifetime_s=d.get("lifetime_s"),
            gang=d.get("gang", ""),
            gang_size=int(d.get("gang_size", 0)),
            labels=dict(d.get("labels", {})),
            namespace=d.get("namespace", "default"))

    def pod_dict(self) -> dict:
        """The arrival's pod manifest: one container with cpu and memory
        requests, and a gang member's coscheduling labels."""
        labels = dict(self.labels)
        if self.gang and self.gang_size > 1:
            labels.setdefault(GROUP_NAME_LABEL, self.gang)
            labels.setdefault(MIN_AVAILABLE_LABEL, str(self.gang_size))
        spec: dict = {"containers": [
            {"name": "c", "image": "registry/fake:1",
             "resources": {"requests": {
                 "cpu": f"{self.cpu_milli}m",
                 "memory": f"{self.memory_mib}Mi"}}}]}
        if self.priority:
            spec["priority"] = self.priority
        return {"metadata": {"name": self.name, "namespace": self.namespace,
                             "labels": labels},
                "spec": spec}


@dataclass
class Trace:
    """Arrival-ordered events with the family and seed they came from."""

    events: List[TraceEvent]
    family: str = ""
    seed: int = 0
    duration_s: float = 0.0

    @property
    def offered_rate(self) -> float:
        """Mean arrivals a second over the trace's span."""
        if not self.events:
            return 0.0
        span = self.duration_s or max(e.t for e in self.events) or 1.0
        return len(self.events) / span if span > 0 else 0.0


def generate_trace(
    seed: int,
    count: int,
    duration_s: float,
    *,
    family: str = "generic",
    name_prefix: str = "tr-",
    cpu_alpha: float = 1.5,
    cpu_lo: int = 100,
    cpu_hi: int = 4000,
    mem_per_cpu_mib: float = 1.0,
    lifetime_modes=((0.8, math.log(8.0), 0.8),
                    (0.2, math.log(120.0), 0.6)),
    priorities=((1.0, 0),),
    burst_factor: float = 3.0,
    burst_period_s: float = 10.0,
    namespace: str = "default",
) -> Trace:
    """``count`` arrivals over ``duration_s``: Poisson-burst offsets,
    bounded-Pareto cpu, memory proportional with jitter, lognormal-
    mixture lifetimes (none when ``lifetime_modes`` is None) and a
    weighted priority mix."""
    rng = Random(seed)
    offsets = arrivals_exactly(rng, count, duration_s,
                               burst_factor=burst_factor,
                               burst_period_s=burst_period_s)
    prio_total = sum(w for w, _ in priorities)
    events: List[TraceEvent] = []
    for i, t in enumerate(offsets):
        cpu = int(bounded_pareto(rng, cpu_alpha, cpu_lo, cpu_hi))
        mem = max(64, int(cpu * mem_per_cpu_mib * rng.uniform(0.75, 1.25)))
        pick = rng.random() * prio_total
        acc, prio = 0.0, priorities[-1][1]
        for w, p in priorities:
            acc += w
            if pick <= acc:
                prio = p
                break
        life = lognormal_mixture(rng, lifetime_modes) \
            if lifetime_modes else None
        events.append(TraceEvent(
            t=round(t, 6), name=f"{name_prefix}{i}", cpu_milli=cpu,
            memory_mib=mem, priority=prio,
            lifetime_s=round(life, 3) if life is not None else None,
            namespace=namespace))
    return Trace(events=events, family=family, seed=seed,
                 duration_s=duration_s)


def events_to_pods(events: Iterable[TraceEvent]) -> List[Pod]:
    """Pods for a run of events, their uids made from the event names."""
    out = []
    for e in events:
        pod = Pod.from_dict(e.pod_dict())
        pod.metadata.uid = f"rp-{e.name}"
        out.append(pod)
    return out
