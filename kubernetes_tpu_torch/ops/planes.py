"""The solve's plane layout: every per-node array is one row of a flat
``[C, N]`` int32 (or f32) tensor, so column ``j`` of every plane is node
``j`` of the encoding.

Static planes (solve-invariant): alloc[R] | max_pods | masks[U] |
sc_codes[SC] | sc_domain[U*SC] | term_codes[T] | node_valid.

State planes (carried from batch to batch and updated in place by the
solve): requested[R] | nonzero[2] | pod_count | sc_counts[SC] |
term_counts[T] | term_owners[T] | sv_attached[SV] | totals, whose first
T columns hold each term's count over real domain values. SV is 0 in an
epoch without shared CSI volumes; else row s is 1 on the nodes the
volume of slot s is attached to.

Topology counts are kept per node: column ``j`` of ``sc_counts[c]`` is
the number of matching pods in node ``j``'s domain, so a commit to node
``j`` adds to every column whose code equals ``j``'s code, and no solve
step ever gathers by value code.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops.encode import EncodedBatch, EncodedCluster
from kubernetes_tpu_torch.ops.solver import pack_podin


class PStatic(NamedTuple):
    """Solve-invariant planes on the device, with their dimensions."""

    ints: torch.Tensor      # [C_s, N] int32
    f32s: torch.Tensor      # [U, N] float32: static scores per profile
    sc_meta: torch.Tensor   # [2, SC] int32: max_skew row, hard row
    r: int
    sc: int
    t: int
    u: int
    v: int                  # number of real topology values
    sv: int = 0             # shared-volume slots (rows of sv_attached)


def static_planes(r: int, sc: int, t: int, u: int) -> Tuple[Dict[str, int],
                                                            int]:
    """Row offsets of the static planes, and their count."""
    o, i = {}, 0
    for name, rows in (("alloc", r), ("max_pods", 1), ("masks", u),
                       ("sc_codes", sc), ("sc_domain", u * sc),
                       ("term_codes", t), ("node_valid", 1)):
        o[name] = i
        i += rows
    return o, i


def state_planes(r: int, sc: int, t: int, sv: int = 0
                 ) -> Tuple[Dict[str, int], int]:
    """Row offsets of the state planes, and their count."""
    o, i = {}, 0
    for name, rows in (("requested", r), ("nonzero", 2), ("pod_count", 1),
                       ("sc_counts", sc), ("term_counts", t),
                       ("term_owners", t), ("sv_attached", sv),
                       ("totals", 1)):
        o[name] = i
        i += rows
    return o, i


def _codes(cluster: EncodedCluster, batch: EncodedBatch):
    v = batch.num_values
    sc_codes = np.minimum(cluster.topo_codes[:, batch.sc_key_idx].T,
                          v).astype(np.int32)                  # [SC, N]
    term_codes = np.minimum(cluster.topo_codes[:, batch.term_key_idx].T,
                            v).astype(np.int32)                # [T, N]
    return sc_codes, term_codes


def _static_arrays(cluster: EncodedCluster, batch: EncodedBatch):
    n = cluster.allocatable.shape[0]
    r = cluster.allocatable.shape[1]
    scn = batch.sc_counts.shape[0]
    tn = batch.term_counts.shape[0]
    u = batch.static_masks.shape[0]
    sc_codes, term_codes = _codes(cluster, batch)
    # eligible-domain mask per node: dom[u, sc, n] = sc_domain[u, sc,
    # code(sc, n)]; the sentinel column V is never eligible
    dom_node = np.take_along_axis(batch.sc_domain.astype(np.int32),
                                  sc_codes[None, :, :], axis=2)
    so, cs = static_planes(r, scn, tn, u)
    ints = np.zeros((cs, n), dtype=np.int32)
    ints[so["alloc"]:so["alloc"] + r] = cluster.allocatable.T
    ints[so["max_pods"]] = cluster.max_pods
    ints[so["masks"]:so["masks"] + u] = batch.static_masks
    ints[so["sc_codes"]:so["sc_codes"] + scn] = sc_codes
    ints[so["sc_domain"]:so["sc_domain"] + u * scn] = dom_node.reshape(
        u * scn, n)
    ints[so["term_codes"]:so["term_codes"] + tn] = term_codes
    ints[so["node_valid"], : cluster.num_real_nodes] = 1
    sc_meta = np.stack([batch.sc_max_skew.astype(np.int32),
                        batch.sc_hard.astype(np.int32)])
    return ints, batch.static_scores.astype(np.float32), sc_meta


def _state_array(cluster: EncodedCluster, batch: EncodedBatch) -> np.ndarray:
    n = cluster.allocatable.shape[0]
    r = cluster.allocatable.shape[1]
    scn = batch.sc_counts.shape[0]
    tn = batch.term_counts.shape[0]
    v = batch.num_values
    if tn > n:
        raise ValueError(
            f"the totals plane holds one column per tracked term; {tn} "
            f"terms exceed its {n} columns")
    sc_codes, term_codes = _codes(cluster, batch)
    svn = _sv_rows(cluster)
    do, cd = state_planes(r, scn, tn, svn)
    planes = np.zeros((cd, n), dtype=np.int32)
    planes[do["requested"]:do["requested"] + r] = cluster.requested.T
    planes[do["nonzero"]:do["nonzero"] + 2] = cluster.nonzero_requested.T
    planes[do["pod_count"]] = cluster.pod_count
    planes[do["sc_counts"]:do["sc_counts"] + scn] = np.take_along_axis(
        batch.sc_counts, sc_codes, axis=1)
    planes[do["term_counts"]:do["term_counts"] + tn] = np.take_along_axis(
        batch.term_counts, term_codes, axis=1)
    planes[do["term_owners"]:do["term_owners"] + tn] = np.take_along_axis(
        batch.term_owners, term_codes, axis=1)
    if svn:
        planes[do["sv_attached"]:do["sv_attached"] + svn] = \
            cluster.sv_attached
    planes[do["totals"], :tn] = batch.term_counts[:, :v].sum(axis=1)
    return planes


def _sv_rows(cluster: EncodedCluster) -> int:
    return 0 if cluster.sv_attached is None else cluster.sv_attached.shape[0]


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def prepare(cluster: EncodedCluster, batch: EncodedBatch, device
            ) -> Tuple[PStatic, torch.Tensor]:
    """Pack the encoder's output into planes on ``device``: the static
    planes and a fresh state."""
    if cluster.allocatable.shape[0] % 128 != 0:
        raise ValueError("padded node count must be a multiple of 128")
    ints, f32s, sc_meta = _static_arrays(cluster, batch)
    pstatic = PStatic(
        ints=_put(ints, device), f32s=_put(f32s, device),
        sc_meta=_put(sc_meta, device),
        r=cluster.allocatable.shape[1], sc=batch.sc_counts.shape[0],
        t=batch.term_counts.shape[0], u=batch.static_masks.shape[0],
        v=batch.num_values, sv=_sv_rows(cluster),
    )
    return pstatic, prepare_state(cluster, batch, device)


def prepare_state(cluster: EncodedCluster, batch: EncodedBatch, device
                  ) -> torch.Tensor:
    """The state planes alone, on ``device``."""
    return _put(_state_array(cluster, batch), device)


# EncodedCluster / EncodedBatch fields from_reference reads (and
# ``sv_attached`` and ``pod_sv``, where the epoch has them)
_CLUSTER_FIELDS = ("allocatable", "requested", "nonzero_requested",
                   "pod_count", "max_pods", "topo_codes")
_BATCH_FIELDS = (
    "requests", "nonzero_requests", "profile_idx", "inexpressible", "pod_sc",
    "pod_sc_match", "match_by", "own_aff", "own_anti", "pref_weight",
    "static_masks", "affinity_masks", "static_scores", "sc_key_idx",
    "sc_max_skew", "sc_hard", "sc_counts", "sc_domain", "term_key_idx",
    "term_counts", "term_owners",
)


def from_reference(arrays: Dict[str, object], device
                   ) -> Tuple[PStatic, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Carry an encoded problem over from plain numpy arrays keyed by
    field name, as another implementation of the same encoding produced
    them. ``arrays`` holds either

    - the EncodedCluster / EncodedBatch fields (plus ``num_real_nodes``,
      ``num_real_pods`` and ``num_values``), which are packed here; or
    - packed planes: ``ints`` and ``f32s`` (``[C, N]``, or ``[C, N/128,
      128]``, the same memory), ``sc_meta``, ``planes``, ``pod_ints``,
      ``pod_floats``, ``num_values`` and, for an epoch with shared-volume
      slots, ``sv`` (the number of ``sv_attached`` rows in ``planes``).

    The fields' form also carries ``sv_attached`` and ``pod_sv`` where
    present.

    Returns (static planes, state, pod ints, pod floats) on ``device``.
    """
    if "planes" in arrays:
        ints = np.asarray(arrays["ints"], dtype=np.int32)
        f32s = np.asarray(arrays["f32s"], dtype=np.float32)
        planes = np.asarray(arrays["planes"], dtype=np.int32)
        sc_meta = np.asarray(arrays["sc_meta"], dtype=np.int32)
        pod_ints = np.asarray(arrays["pod_ints"], dtype=np.int32)
        pod_floats = np.asarray(arrays["pod_floats"], dtype=np.float32)
        sc, u, t = sc_meta.shape[1], f32s.shape[0], pod_floats.shape[1]
        sv = int(arrays.get("sv", 0))
        r = pod_ints.shape[1] - 4 - 2 * sc - 3 * t - (2 if sv else 0)
        pstatic = PStatic(
            ints=_put(ints.reshape(ints.shape[0], -1), device),
            f32s=_put(f32s.reshape(u, -1), device),
            sc_meta=_put(sc_meta, device),
            r=r, sc=sc, t=t, u=u, v=int(arrays["num_values"]), sv=sv,
        )
        if pstatic.ints.shape[0] != static_planes(r, sc, t, u)[1]:
            raise ValueError("static planes do not match the pod stream's "
                             "dimensions")
        state = _put(planes.reshape(planes.shape[0], -1), device)
        return (pstatic, state, _put(pod_ints, device),
                _put(pod_floats, device))
    cluster = EncodedCluster(
        node_names=[], num_real_nodes=int(arrays["num_real_nodes"]),
        resource_names=[],
        sv_attached=(None if arrays.get("sv_attached") is None
                     else np.asarray(arrays["sv_attached"])),
        **{k: np.asarray(arrays[k]) for k in _CLUSTER_FIELDS})
    pod_sv = arrays.get("pod_sv")
    batch = EncodedBatch(
        pods=[], num_real_pods=int(arrays["num_real_pods"]),
        num_values=int(arrays["num_values"]),
        pod_sv=None if pod_sv is None else np.asarray(pod_sv),
        **{k: np.asarray(arrays[k]) for k in _BATCH_FIELDS})
    pstatic, state = prepare(cluster, batch, device)
    pod_ints, pod_floats = pack_podin(batch)
    return pstatic, state, _put(pod_ints, device), _put(pod_floats, device)
