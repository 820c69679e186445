"""The controller shape of the reference's ``pkg/controller/``: event
handlers (or a periodic tick) enqueue keys on a rate-limited workqueue;
worker threads pop keys and reconcile, requeueing with backoff on an
error and forgetting the key on success."""

from __future__ import annotations

import copy
import logging
import threading
from typing import List, Optional

from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.client.informers import SharedInformerFactory
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue

_logger = logging.getLogger(__name__)


class Controller:
    """Subclasses set ``name``, wire handlers in ``register`` and
    implement ``sync(key)``; with ``RESYNC_SECONDS`` set, ``resync`` runs
    on a tick thread (started by ``run``, joined by ``stop``)."""

    name = "controller"
    workers = 1
    max_requeues = 10
    RESYNC_SECONDS: Optional[float] = None

    def __init__(self, store: ClusterStore, factory: SharedInformerFactory):
        self.store = store
        self.factory = factory
        self.queue = RateLimitingQueue()
        self._threads: List[threading.Thread] = []
        self._stopped = False
        self._tick_stop = threading.Event()
        self._tick_thread: Optional[threading.Thread] = None
        self.register()

    def register(self) -> None:
        raise NotImplementedError

    def sync(self, key: str) -> None:
        raise NotImplementedError

    def resync(self) -> None:
        """The periodic hook, every ``RESYNC_SECONDS``."""

    def _tick_loop(self) -> None:
        while not self._tick_stop.wait(self.RESYNC_SECONDS):
            try:
                self.resync()
            except Exception:  # noqa: BLE001 — the tick must not die
                _logger.exception("%s: resync failed", self.name)

    def enqueue(self, obj) -> None:
        """Queue the object's key: ``namespace/name``, or the bare name
        where the namespace is empty."""
        meta = obj.metadata
        ns = getattr(meta, "namespace", "")
        self.queue.add(f"{ns}/{meta.name}" if ns else meta.name)

    def enqueue_key(self, key: str) -> None:
        self.queue.add(key)

    def run(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{self.name}-{i}")
            t.start()
            self._threads.append(t)
        if self.RESYNC_SECONDS is not None:
            self._tick_thread = threading.Thread(
                target=self._tick_loop, daemon=True, name=f"{self.name}-tick")
            self._tick_thread.start()

    def _worker(self) -> None:
        while not self._stopped:
            key = self.queue.get(timeout=0.5)
            if key is None:
                if self.queue.shutting_down:
                    return
                continue
            try:
                self.sync(key)
            except Exception:  # noqa: BLE001 — reconcile retries, not dies
                if self.queue.num_requeues(key) < self.max_requeues:
                    _logger.exception("%s: sync %s failed; requeueing",
                                      self.name, key)
                    self.queue.add_rate_limited(key)
                else:
                    _logger.exception("%s: sync %s failed too many times; "
                                      "dropping", self.name, key)
                    self.queue.forget(key)
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)

    def stop(self) -> None:
        self._stopped = True
        self._tick_stop.set()
        self.queue.shutdown()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=2.0)
        for t in self._threads:
            t.join(timeout=2.0)


def split_key(key: str) -> tuple:
    ns, _, name = key.partition("/")
    return ns, name


def controller_of(obj) -> Optional[dict]:
    """The owner reference with ``controller`` set, if any."""
    for r in obj.metadata.owner_references:
        if r.get("controller"):
            return r
    return None


def owner_ref(kind: str, obj) -> dict:
    """A controller owner reference to ``obj`` (metav1.OwnerReference with
    ``controller`` set)."""
    return {"kind": kind, "name": obj.metadata.name, "uid": obj.metadata.uid,
            "controller": True}


def is_owned_by(obj, kind: str, owner) -> bool:
    """Whether ``obj``'s controller reference names ``owner`` of ``kind``
    by uid."""
    return any(r.get("controller") and r.get("kind") == kind
               and r.get("uid") == owner.metadata.uid
               for r in obj.metadata.owner_references)


def with_status(obj, status):
    """A shallow copy of ``obj`` (its metadata copied too) carrying
    ``status``: a controller never edits the store's or an informer's
    instance in place, since watchers compare the old object with the
    new."""
    new = copy.copy(obj)
    new.metadata = copy.copy(obj.metadata)
    new.status = status
    return new
