"""Image garbage collector.

Behavioral equivalent of the reference's
``pkg/kubelet/images/image_gc_manager.go`` (realImageGCManager.GarbageCollect):
when image-disk usage crosses ``high_threshold_percent`` of capacity,
delete least-recently-used images not referenced by any pod on the node
until usage falls to ``low_threshold_percent``. Last-used times come
from pod sightings (``note_image_used``, the analog of detectImages'
imagesInUse scan); freed images leave ``node.status.images`` so the
scheduler's ImageLocality scoring sees the real cache state.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from kubernetes_tpu_torch.api.types import ContainerImage


class ImageGCManager:
    # reference --image-gc-period is 5m; scaled for the harness
    GC_INTERVAL_SECONDS = 5.0
    FREED_LOG_CAP = 1024

    def __init__(self, store, node_name: str, capacity_bytes: int,
                 high_threshold_percent: int = 85,
                 low_threshold_percent: int = 80):
        self.store = store
        self.node_name = node_name
        self.capacity = capacity_bytes
        self.high = high_threshold_percent
        self.low = low_threshold_percent
        self._lock = threading.Lock()
        self._last_used: Dict[str, float] = {}   # image name -> ts
        self.freed: List[str] = []               # observability (capped)
        self._last_gc = 0.0

    def maybe_garbage_collect(self) -> List[str]:
        """Housekeeping entry point: rate-limits full passes to
        ``GC_INTERVAL_SECONDS`` (the kubelet tick is much hotter)."""
        now = time.time()
        if now - self._last_gc < self.GC_INTERVAL_SECONDS:
            return []
        self._last_gc = now
        return self.garbage_collect()

    # ------------------------------------------------------------------
    def note_image_used(self, image: str) -> None:
        """Pod sighting: refresh the image's last-used time
        (detectImages' imagesInUse accounting)."""
        with self._lock:
            self._last_used[image] = time.time()

    def _images_in_use(self) -> set:
        used = set()
        for p in self.store.list_pods():
            if p.spec.node_name != self.node_name:
                continue
            if p.status.phase in ("Succeeded", "Failed"):
                continue
            for c in p.spec.containers:
                if c.image:
                    used.add(c.image)
        return used

    def garbage_collect(self) -> List[str]:
        """One GC pass; returns the freed image names."""
        node = self.store.get_node(self.node_name)
        if node is None:
            return []
        images = list(node.status.images)
        # prune usage records for images no longer on the node (the
        # reference's detectImages drops absent records) — unbounded
        # growth otherwise, one entry per image name ever seen
        present = {n for i in images for n in i.names}
        with self._lock:
            self._last_used = {
                k: v for k, v in self._last_used.items() if k in present
            }
        usage = sum(i.size_bytes for i in images)
        if self.capacity <= 0 or \
                usage * 100 < self.high * self.capacity:
            return []
        target = self.low * self.capacity // 100
        in_use = self._images_in_use()
        with self._lock:
            def last_used(img: ContainerImage) -> float:
                return max(
                    (self._last_used.get(n, 0.0) for n in img.names),
                    default=0.0,
                )

            candidates = sorted(
                (i for i in images
                 if not any(n in in_use for n in i.names)),
                key=last_used,
            )
        freed: List[str] = []
        keep = list(images)
        for img in candidates:
            if usage <= target:
                break
            keep.remove(img)
            usage -= img.size_bytes
            freed.extend(img.names[:1])
        if not freed:
            return []
        freed_names = {n for i in images if i not in keep for n in i.names}

        def mutate(n) -> bool:
            # CAS merge against the LIVE image list: another node-status
            # writer (attachdetach, eviction) may have landed since the
            # read above, and blind last-write-wins would resurrect
            # their fields or our freed images
            n.status.images = [
                i for i in n.status.images
                if not any(name in freed_names for name in i.names)
            ]
            return True

        self.store.mutate_object("Node", "", self.node_name, mutate)
        self.freed = (self.freed + freed)[-self.FREED_LOG_CAP:]
        return freed
