"""MeshLocality: device-mesh adjacency scoring for multi-chip gangs.

Nodes carry their coordinate on the accelerator mesh as
``ktpu.io/mesh-x`` and ``ktpu.io/mesh-y``; pods opt in with
``ktpu.io/mesh-block: <block>`` (normally the gang's name). Every member
of a block shares one anchor coordinate, crc32 of the block name hashed
onto the grid, and a node scores by its Manhattan closeness to it:

    score = MAX_NODE_SCORE / (1 + d(node, anchor))

so a gang packs around its anchor and spills to the next ring under
capacity pressure. Unlabelled pods and nodes score 0.

One closeness function (``profile_scorer``) feeds both paths: the serial
path through the Score plugin (rounded to the framework's integer
scores), the batch path through the encoder's static scores at full
precision, where ``profile_component`` also keeps two blocks out of one
static profile. ``configure(enabled=False)`` turns the scoring off."""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    ScorePlugin,
    Status,
)

MESH_X_LABEL = "ktpu.io/mesh-x"
MESH_Y_LABEL = "ktpu.io/mesh-y"
MESH_BLOCK_LABEL = "ktpu.io/mesh-block"

# module-level: the batch encoder calls the free functions, not the plugin
_ENABLED = True


def configure(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


def enabled() -> bool:
    return _ENABLED


def mesh_node_labels(index: int, cols: int, rows: int = 0) -> dict:
    """The labels of node ``index`` on a cols x rows grid (rows 0: no
    bound, row = index // cols)."""
    x, y = index % cols, index // cols
    if rows:
        y %= rows
    return {MESH_X_LABEL: str(x), MESH_Y_LABEL: str(y)}


def node_coord(node) -> Optional[Tuple[int, int]]:
    labels = node.metadata.labels
    sx, sy = labels.get(MESH_X_LABEL), labels.get(MESH_Y_LABEL)
    if sx is None or sy is None:
        return None
    try:
        return int(sx), int(sy)
    except ValueError:
        return None


def block_anchor(block: str, cols: int, rows: int) -> Tuple[int, int]:
    """The block's anchor: crc32 of its name hashed onto the grid, the
    same in every scheduler and in the batch encoder."""
    h = zlib.crc32(block.encode())
    return (h % max(cols, 1), (h // max(cols, 1)) % max(rows, 1))


def mesh_block(pod: Pod) -> str:
    return pod.metadata.labels.get(MESH_BLOCK_LABEL, "")


def profile_component(pod: Pod) -> tuple:
    """The static profile key's part: pods of different blocks never
    share a static score row; () for unlabelled pods."""
    block = mesh_block(pod)
    return ("mesh", block) if block else ()


def _grid_extent(nodes) -> Tuple[int, int]:
    """Columns and rows spanned by the labelled nodes."""
    cols = rows = 0
    for node in nodes:
        c = node_coord(node)
        if c is not None:
            cols = max(cols, c[0] + 1)
            rows = max(rows, c[1] + 1)
    return cols, rows


def profile_scorer(pod: Pod, all_nodes):
    """``fn(node) -> float``, MAX_NODE_SCORE / (1 + Manhattan distance
    to the pod's block anchor) on the grid ``all_nodes`` span; None when
    the pod has no block, the plugin is off or no node is labelled."""
    if not _ENABLED:
        return None
    block = mesh_block(pod)
    if not block:
        return None
    cols, rows = _grid_extent(all_nodes)
    if not cols or not rows:
        return None
    ax, ay = block_anchor(block, cols, rows)

    def score(node) -> float:
        c = node_coord(node)
        if c is None:
            return 0.0
        d = abs(c[0] - ax) + abs(c[1] - ay)
        return float(MAX_NODE_SCORE) / (1.0 + d)

    return score


class MeshLocality(ScorePlugin):
    """The serial path's face of ``profile_scorer``."""

    NAME = "MeshLocality"

    @staticmethod
    def factory(args, handle):
        return MeshLocality(handle)

    def __init__(self, handle=None):
        self.handle = handle
        # one scorer per (pod, snapshot): the snapshot is held and
        # compared by identity, so a freed one is never matched
        self._memo_uid = None
        self._memo_snap = None
        self._memo_fn = None

    def score(self, state, pod: Pod, node_name: str
              ) -> Tuple[int, Optional[Status]]:
        if not _ENABLED or not mesh_block(pod):
            return 0, None
        snapshot = self.handle.snapshot()
        ni = snapshot.get(node_name)
        if ni is None or ni.node is None:
            return 0, Status(1, f"node {node_name} not found")
        if pod.uid != self._memo_uid or snapshot is not self._memo_snap:
            nodes = [i.node for i in snapshot.list() if i.node is not None]
            self._memo_fn = profile_scorer(pod, nodes)
            self._memo_uid = pod.uid
            self._memo_snap = snapshot
        if self._memo_fn is None:
            return 0, None
        return int(round(self._memo_fn(ni.node))), None
