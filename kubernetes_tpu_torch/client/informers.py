"""Shared informers and listers over the store's batched watch (client-
go's informer machinery: pods and nodes through the store's typed list
methods, any other kind through ``list_objects``). ``start`` replays
each informer's initial list as ADDED events, then the store's watch
batches are queued and drained by one dispatch thread, so handlers run
in commit order and never under the store's lock. Listers read the
informer's indexer: the informer's view, not the store's."""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from kubernetes_tpu_torch.apiserver.store import (
    ADDED,
    DELETED,
    MODIFIED,
    ClusterStore,
    Event,
)

_logger = logging.getLogger(__name__)

# kind -> the store's list method
_KIND_LISTS = {"Pod": "list_pods", "Node": "list_nodes"}
_CLUSTER_SCOPED = {"Node"}


def _meta_key(kind: str, obj: Any) -> str:
    meta = obj.metadata
    if kind in _CLUSTER_SCOPED:
        return meta.name
    return f"{meta.namespace}/{meta.name}"


class ResourceEventHandler:
    """add / update / delete callbacks."""

    def __init__(self, on_add=None, on_update=None, on_delete=None):
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete

    def handle(self, event: Event) -> None:
        if event.type == ADDED and self.on_add is not None:
            self.on_add(event.obj)
        elif event.type == MODIFIED and self.on_update is not None:
            self.on_update(event.old_obj, event.obj)
        elif event.type == DELETED and self.on_delete is not None:
            self.on_delete(event.obj)


class Indexer:
    """Thread-safe key -> object map."""

    def __init__(self, kind: str):
        self.kind = kind
        self._lock = threading.Lock()
        self._items: Dict[str, Any] = {}

    def replace(self, objs: List[Any]) -> None:
        with self._lock:
            self._items = {_meta_key(self.kind, o): o for o in objs}

    def apply(self, event: Event) -> None:
        key = _meta_key(self.kind, event.obj)
        with self._lock:
            if event.type == DELETED:
                self._items.pop(key, None)
            else:
                self._items[key] = event.obj

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._items.values())


class SharedInformer:
    """One kind's indexer and handlers."""

    def __init__(self, kind: str, list_fn: Callable[[], List[Any]]):
        self.kind = kind
        self._list_fn = list_fn
        self.indexer = Indexer(kind)
        self._handlers: List[ResourceEventHandler] = []
        self._synced = False

    def add_event_handler(self, on_add=None, on_update=None, on_delete=None
                          ) -> ResourceEventHandler:
        h = ResourceEventHandler(on_add, on_update, on_delete)
        self._handlers.append(h)
        return h

    def has_synced(self) -> bool:
        return self._synced

    def _sync(self) -> List[Event]:
        objs = self._list_fn()
        self.indexer.replace(objs)
        self._synced = True
        return [Event(ADDED, self.kind, o) for o in objs]

    def _dispatch(self, event: Event) -> None:
        for h in list(self._handlers):
            try:
                h.handle(event)
            except Exception:  # noqa: BLE001 — one handler must not stop
                _logger.exception("event handler failed for %s %s",
                                  event.kind, event.type)


class Lister:
    """Reads an informer's indexer."""

    def __init__(self, informer: SharedInformer):
        self._informer = informer

    def list(self) -> List[Any]:
        return self._informer.indexer.list()

    def by_namespace(self, namespace: str) -> List[Any]:
        return [o for o in self._informer.indexer.list()
                if getattr(o.metadata, "namespace", "") == namespace]


class SharedInformerFactory:
    """One store's informers. ``start`` watches the store and replays the
    initial lists on the dispatch thread; ``wait_for_cache_sync`` blocks
    until the replay is done; an informer asked for after ``start`` syncs
    on the dispatch thread."""

    def __init__(self, store: ClusterStore):
        self._store = store
        self._informers: Dict[str, SharedInformer] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._deltas: deque = deque()
        self._pending_sync: List[SharedInformer] = []
        self._watch_handle = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._synced_event = threading.Event()

    def informer_for(self, kind: str) -> SharedInformer:
        with self._cond:
            inf = self._informers.get(kind)
            if inf is None:
                # a kind without a typed list method (or a store-shaped
                # client without it) lists through the generic verb
                list_name = _KIND_LISTS.get(kind)
                list_fn = getattr(self._store, list_name, None) \
                    if list_name is not None else None
                if list_fn is None:
                    list_fn = (
                        lambda kind=kind: self._store.list_objects(kind))
                inf = SharedInformer(kind, list_fn)
                self._informers[kind] = inf
                if self._thread is not None:
                    self._pending_sync.append(inf)
                    self._cond.notify()
            return inf

    def lister_for(self, kind: str) -> Lister:
        return Lister(self.informer_for(kind))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._watch_handle = self._store.watch(self._enqueue_many)
        self._thread = threading.Thread(target=self._process_loop,
                                        daemon=True, name="informer-factory")
        self._thread.start()

    def _enqueue_many(self, events: List[Event]) -> None:
        with self._cond:
            if not self._stopped:
                self._deltas.extend(events)
                self._cond.notify()

    def _process_loop(self) -> None:
        with self._cond:
            initial = list(self._informers.values())
        for inf in initial:
            self._sync_one(inf)
        self._synced_event.set()
        while True:
            with self._cond:
                while not (self._deltas or self._pending_sync
                           or self._stopped):
                    self._cond.wait(0.5)
                if self._stopped and not self._deltas:
                    return
                pending, self._pending_sync = self._pending_sync, []
                events = list(self._deltas)
                self._deltas.clear()
            for inf in pending:
                self._sync_one(inf)
            for event in events:
                self._ingest(event)

    def _ingest(self, event: Event) -> None:
        inf = self._informers.get(event.kind)
        if inf is None or not inf.has_synced():
            return
        if event.type == ADDED:
            # an ADDED that raced the initial list is in the indexer at
            # the same resource version already
            known = inf.indexer.get(_meta_key(inf.kind, event.obj))
            if known is not None and known.metadata.resource_version \
                    == event.obj.metadata.resource_version:
                return
        inf.indexer.apply(event)
        inf._dispatch(event)

    def _sync_one(self, inf: SharedInformer) -> None:
        try:
            for ev in inf._sync():
                inf._dispatch(ev)
        except Exception:  # noqa: BLE001 — the dispatch thread must live
            _logger.exception("informer %s initial sync failed", inf.kind)

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        return self._synced_event.wait(timeout)

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._watch_handle is not None:
            self._watch_handle.stop()
            self._watch_handle = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
