"""Solve parameters and the packed pod stream.

A batch is solved in queue order, one pod at a time: every node is
checked (capacity, pod count, static profile mask, hard topology spread,
inter-pod (anti-)affinity) and scored (balanced and least allocation,
soft spread, preferred affinity, static score); the best node, lowest
index on ties, takes the pod, and the state is updated before the next
pod. ``ops.solve`` runs that loop."""

from __future__ import annotations

from dataclasses import astuple, dataclass
from typing import Tuple

import numpy as np

NEG_INF = -1e30
BIG = 2**30


@dataclass(frozen=True)
class SolverParams:
    """Score weights: balanced 1, least-allocated 1, topology spread 2,
    inter-pod affinity 1, static 1."""

    balanced_weight: float = 1.0
    least_weight: float = 1.0
    spread_weight: float = 2.0
    affinity_weight: float = 1.0
    static_weight: float = 1.0

    def as_tuple(self) -> Tuple[float, ...]:
        return astuple(self)


def pack_podin(batch) -> Tuple[np.ndarray, np.ndarray]:
    """The pod stream as two arrays: int32 ``[B, R+4+2*SC+3*T]`` with
    columns request[R] | nonzero[2] | profile | valid | pod_sc[SC] |
    sc_match[SC] | match_by[T] | own_aff[T] | own_anti[T], then, in an
    epoch with shared-volume slots (``batch.pod_sv``), two more: the
    pod's slot and attach column; and the f32 preferred weights
    ``[B, T]``. Rows past the real pods are invalid."""
    b = batch.requests.shape[0]
    valid = np.zeros(b, dtype=bool)
    valid[: batch.num_real_pods] = True
    valid &= ~batch.inexpressible
    cols = [
        batch.requests,
        batch.nonzero_requests,
        batch.profile_idx.reshape(b, 1),
        valid.reshape(b, 1).astype(np.int32),
        batch.pod_sc.astype(np.int32),
        batch.pod_sc_match.astype(np.int32),
        batch.match_by.astype(np.int32),
        batch.own_aff.astype(np.int32),
        batch.own_anti.astype(np.int32),
    ]
    if batch.pod_sv is not None:
        cols.append(batch.pod_sv)
    ints = np.concatenate(cols, axis=1, dtype=np.int32)
    return ints, np.asarray(batch.pref_weight, dtype=np.float32)
