"""Lease-based leader election (upstream
``client-go/tools/leaderelection``): candidates race to acquire or renew
a lease in the store (``ClusterStore.try_acquire_or_renew``); the holder
runs ``on_started_leading`` on a thread of its own and renews every
``retry_period``; a holder that cannot renew within ``renew_deadline``
has lost the lease and runs ``on_stopped_leading`` (upstream's scheduler
exits there; ``Scheduler.run_with_leader_election`` stops for good).
Times come from ``clock`` (``utils.clock``), the waits from the real
clock."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.utils.clock import RealClock


@dataclass
class LeaderElectionConfig:
    lock_name: str = "kube-scheduler"
    identity: str = "scheduler-0"
    lease_duration: float = 15.0   # upstream defaults: 15 s / 10 s / 2 s
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    on_started_leading: Optional[Callable[[], None]] = None
    on_stopped_leading: Optional[Callable[[], None]] = None


class LeaderElector:
    def __init__(self, store: ClusterStore, config: LeaderElectionConfig,
                 clock=None):
        self._store = store
        self.config = config
        self._clock = clock or RealClock()
        self._stop = threading.Event()
        self._is_leader = False

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def try_acquire_or_renew(self) -> bool:
        return self._store.try_acquire_or_renew(
            self.config.lock_name, self.config.identity,
            self._clock.now(), self.config.lease_duration,
        )

    def holds_lease(self) -> bool:
        """Does the store's lease name this candidate now? False once
        another candidate has taken it, even while this one still counts
        down its renew deadline."""
        return (self._store.lease_holder(self.config.lock_name)
                == self.config.identity)

    def run(self) -> None:
        """Blocks: acquire loop → leading callback → renew loop."""
        while not self._stop.is_set():
            if self.try_acquire_or_renew():
                self._is_leader = True
                if self.config.on_started_leading is not None:
                    # on a thread of its own, so a blocking workload
                    # cannot starve the renewals
                    threading.Thread(
                        target=self.config.on_started_leading,
                        daemon=True, name="leading",
                    ).start()
                self._renew_loop()
                self._is_leader = False
                if self.config.on_stopped_leading is not None:
                    self.config.on_stopped_leading()
                if self._stop.is_set():
                    return
            self._stop.wait(self.config.retry_period)

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True, name="leader-elect")
        t.start()
        return t

    def _renew_loop(self) -> None:
        while not self._stop.is_set():
            deadline = self._clock.now() + self.config.renew_deadline
            renewed = False
            while self._clock.now() < deadline and not self._stop.is_set():
                if self.try_acquire_or_renew():
                    renewed = True
                    break
                self._stop.wait(self.config.retry_period)
            if not renewed:
                return  # lost the lease
            self._stop.wait(self.config.retry_period)

    def stop(self) -> None:
        self._stop.set()
