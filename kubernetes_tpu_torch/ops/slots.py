"""The sparse term-slot stream: each pod's term work cut to the few terms
it references.

A pod names only the handful of terms its own (anti-)affinity requires
or prefers, or whose selector it matches: on SchedulingPodAntiAffinity
one term of 100 tracked. The slot stream keeps the pod's base columns
and, for at most ``SPARSE_K`` slots, the term index, its flags and its
preferred weight, in increasing term order. The state planes are the
dense ones; a solve reads and updates a term row only through a slot.

The pack is the reference's (``pallas_solver.py::pack_sparse_slots``,
copied): the batch packs unless some pod references more than
``SPARSE_K`` terms, and the route is worth taking from ``SPARSE_MIN_T``
tracked terms up.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

SPARSE_K = 8          # most term references a pod may have in a slot batch
SPARSE_MIN_T = 12     # fewer tracked terms take the dense stream

# slot flag bits
MATCHED, OWN_AFF, OWN_ANTI = 1, 2, 4


def pack_sparse_slots(ints: np.ndarray, floats: np.ndarray, r: int,
                      sc: int, t: int):
    """Per-pod term slots of the dense pod stream (``pack_podin``).
    Returns (base ints ``[B, R+4+2*SC]``, slot index ``[B, K]``, slot
    flags ``[B, K]``, slot weight ``[B, K]`` f32), or None when any pod
    references more than ``SPARSE_K`` terms. A referenced term is one the
    pod matches, requires (affinity or anti-affinity) or weighs; its
    flags pack matched, own affinity and own anti-affinity as bits 0, 1
    and 2. Slots past a pod's references are inactive: index 0, flags 0,
    weight 0.0 (index 0 is also a real term, so only the flags and the
    weight say a slot is inactive)."""
    c_match_by = r + 4 + 2 * sc
    mb = ints[:, c_match_by:c_match_by + t] != 0
    oa = ints[:, c_match_by + t:c_match_by + 2 * t] != 0
    oan = ints[:, c_match_by + 2 * t:c_match_by + 3 * t] != 0
    w = floats[:, :t]
    ref = mb | oa | oan | (w != 0.0)
    if ref.sum(axis=1).max(initial=0) > SPARSE_K:
        return None
    # a stable argsort puts the referenced term indices first, in order
    order = np.argsort(~ref, axis=1, kind="stable")[:, :SPARSE_K]
    active = np.take_along_axis(ref, order, axis=1)
    slot_idx = np.where(active, order, 0).astype(np.int32)
    flags = (
        np.take_along_axis(mb, order, axis=1).astype(np.int32)
        | (np.take_along_axis(oa, order, axis=1).astype(np.int32) << 1)
        | (np.take_along_axis(oan, order, axis=1).astype(np.int32) << 2)
    )
    flags = np.where(active, flags, 0)
    slot_w = np.where(
        active, np.take_along_axis(w, order, axis=1), 0.0
    ).astype(np.float32)
    base = np.ascontiguousarray(ints[:, :c_match_by])
    return base, slot_idx, flags, slot_w


def slot_stream(ints: np.ndarray, floats: np.ndarray, r: int, sc: int,
                t: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The slot stream the slot solves take, or None when the batch does
    not pack: int32 ``[B, R+4+2*SC+2*K]`` (base columns | slot index |
    slot flags) and the f32 slot weights ``[B, K]``. The slots' columns
    sit where the dense stream's term columns begin."""
    packed = pack_sparse_slots(ints, floats, r, sc, t)
    if packed is None:
        return None
    base, slot_idx, flags, slot_w = packed
    return (np.concatenate([base, slot_idx, flags], axis=1, dtype=np.int32),
            slot_w)


def slot_width(r: int, sc: int) -> int:
    """Int columns of a slot-stream row."""
    return r + 4 + 2 * sc + 2 * SPARSE_K


def slot_refs(row: List[int], wrow: List[float], r: int, sc: int
              ) -> List[Tuple[int, int, int, int, float]]:
    """A slot-stream row's active slots as (term, matched, own affinity,
    own anti-affinity, weight), in term order."""
    c = r + 4 + 2 * sc
    out = []
    for s in range(SPARSE_K):
        flags, w = row[c + SPARSE_K + s], wrow[s]
        if flags or w != 0.0:
            out.append((row[c + s], flags & MATCHED, (flags & OWN_AFF) >> 1,
                        (flags & OWN_ANTI) >> 2, w))
    return out
