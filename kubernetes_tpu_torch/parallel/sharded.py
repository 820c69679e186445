"""The sharded tier: the batch solve with the node axis over S shards.

Counterpart of the reference's mesh tier (``parallel/sharded.py`` of the
JAX package: a ``shard_map`` over a ("batch", "nodes") mesh). Every
plane keeps the single-card layout (``ops/planes.py``); shard ``s`` owns
the contiguous columns ``[s*N/S, (s+1)*N/S)``. Per pod, each shard
filters and scores its own columns and offers its best: the score, the
lowest global index at that score and that column's SC+T codes. The
winner is the highest score, then the lowest index, and every shard
commits it to its own columns, reading the winner's codes from the
winning shard's offer. A batch with a hard spread constraint first takes
the least per-constraint domain count over the shards. The per-term
totals live outside the planes, one copy a shard (``SState.totals``,
``[S, T]``), each updated by its shard: the planes' totals row stays as
the batch found it, as the reference's scan leaves it.

One card stands in for the mesh, in one launch of
``solve_sharded_kernel`` (``csrc/solve_kernel.cu``). Where the shard
count divides the cluster size (16 blocks, or 8), shard ``s`` is the
``s``-th group of blocks of one cluster and the offers meet in
distributed shared memory where the reference has an ``all_gather``;
else shard ``s`` is cluster ``s`` and the offers go through global
memory. The per-pod feasibility counts (``solve_scan_sharded``) are
``feasible_counts_kernel``. A mesh over more than one card is not built
(ROADMAP §A10).

The plain versions (``solve_sharded_plain``, ``feasible_counts_plain``)
are written from the reference's step: each shard's offer and the
resolution of the ``[S, 2+SC+T]`` block, as tensor operations over the
``S`` column slices. The wrappers take them for tensors on the CPU and
launch the kernels for tensors on the card; nothing falls back.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.encode import EncodedBatch, EncodedCluster
from kubernetes_tpu_torch.ops.planes import (
    PStatic,
    prepare,
    prepare_state,
    state_planes,
    static_planes,
)
from kubernetes_tpu_torch.ops.solve import (
    CudaPlanesBackend,
    SolveHandle,
    _pod_columns,
    check_profiles,
    check_sv,
)
from kubernetes_tpu_torch.ops.solver import (
    BIG,
    NEG_INF,
    SolverParams,
    pack_podin,
)


class Mesh(NamedTuple):
    """A (batch, nodes) mesh on one device: ``shape["nodes"]`` shards of
    the node axis, ``shape["batch"]`` slices of the pod axis for the
    feasibility counts."""

    shape: dict
    device: torch.device


def make_mesh(n_shards: Optional[int] = None, batch_axis: int = 1,
              device: Union[None, str, torch.device, Sequence] = None
              ) -> Mesh:
    """A mesh of ``n_shards`` (default: one a device given) over
    ``batch_axis`` x ``n_shards // batch_axis``: ``make_mesh(8,
    batch_axis=2)`` has 4 node shards. ``device`` is the card unless
    "cpu" is passed; shards on more than one device are not supported."""
    devices = list(device) if isinstance(device, (list, tuple)) \
        else [device]
    named = {str(torch.device(d)) for d in devices if d is not None}
    if len(named) > 1:
        raise NotImplementedError(
            f"a mesh over {sorted(named)}: the sharded tier runs its "
            "shards on one device; the multi-card build is ROADMAP §A10")
    n = n_shards or len(devices)
    if batch_axis < 1 or n % batch_axis != 0:
        raise ValueError(f"{n} shards do not split into a batch axis of "
                         f"{batch_axis}")
    return Mesh({"batch": batch_axis, "nodes": n // batch_axis},
                resolve_device(devices[0]))


class SStatic(NamedTuple):
    """Solve-invariant planes in the sharded layout (the single-card
    planes; shard s owns columns [s*N/S, (s+1)*N/S))."""

    sc_meta: torch.Tensor    # [2, SC] int32
    ints: torch.Tensor       # [C_s, N] int32
    f32s: torch.Tensor       # [U, N] float32
    has_dom: torch.Tensor    # [U, SC] int32: the profile has an eligible
    #                          domain value for the constraint
    r: int
    sc: int
    t: int
    u: int
    v: int
    n: int
    sv: int = 0
    # a hard spread constraint among the batch's: the launch takes the
    # instance with the round of domain minima
    any_hard: bool = True


class SState(NamedTuple):
    """The state carried across batches: the planes ([C_d, N], their
    totals row left as found) and each shard's copy of the per-term
    totals ([S, T])."""

    planes: torch.Tensor
    totals: torch.Tensor


def _sharded(ps: PStatic, state: torch.Tensor, has_dom: torch.Tensor,
             any_hard: bool, shards: int) -> Tuple[SStatic, SState]:
    n = ps.ints.shape[1]
    if n % shards != 0:
        raise ValueError(f"padded node count {n} not divisible by mesh "
                         f"nodes axis {shards}")
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    totals = state[do["totals"], :ps.t].repeat(shards, 1).contiguous()
    ss = SStatic(sc_meta=ps.sc_meta, ints=ps.ints, f32s=ps.f32s,
                 has_dom=has_dom.to(ps.ints.device, torch.int32).contiguous(),
                 r=ps.r, sc=ps.sc, t=ps.t, u=ps.u, v=ps.v, n=n, sv=ps.sv,
                 any_hard=any_hard)
    return ss, SState(planes=state, totals=totals)


def shard_planes(ps: PStatic, state: torch.Tensor, shards: int
                 ) -> Tuple[SStatic, SState]:
    """Single-card planes as sharded ones (copies of the state), for
    problems given as planes: each profile's domain existence is whether
    any column lies in an eligible domain, and the batch has a hard
    constraint where ``sc_meta``'s hard row says so."""
    so, _ = static_planes(ps.r, ps.sc, ps.t, ps.u)
    dom = ps.ints[so["sc_domain"]:so["sc_domain"] + ps.u * ps.sc] > 0
    has_dom = dom.any(dim=1).view(ps.u, ps.sc)
    any_hard = bool((ps.sc_meta[1] > 0).any())
    return _sharded(ps, state.clone(), has_dom, any_hard, shards)


def _prepare_sharded(cluster: EncodedCluster, batch: EncodedBatch,
                     mesh: Mesh) -> Tuple[SStatic, SState]:
    """The encoder's output as sharded planes on the mesh's device: the
    domain existence hoisted from ``batch.sc_domain`` over the real
    values, ``any_hard`` from ``batch.sc_hard``."""
    ps, state = prepare(cluster, batch, mesh.device)
    v = batch.num_values
    has_dom = torch.from_numpy(np.ascontiguousarray(
        batch.sc_domain[:, :, :v].any(axis=2).astype(np.int32)))
    return _sharded(ps, state, has_dom, bool(np.asarray(batch.sc_hard).any()),
                    mesh.shape["nodes"])


def _host_state_planes(cluster: EncodedCluster, batch: EncodedBatch,
                       shards: int, device) -> SState:
    """The state planes and the shards' totals from an encoding."""
    state = prepare_state(cluster, batch, device)
    t = batch.term_counts.shape[0]
    if state.shape[1] % shards != 0:
        raise ValueError(f"padded node count {state.shape[1]} not divisible "
                         f"by mesh nodes axis {shards}")
    do, _ = state_planes(cluster.allocatable.shape[1],
                         batch.sc_counts.shape[0], t,
                         0 if cluster.sv_attached is None
                         else cluster.sv_attached.shape[0])
    return SState(planes=state, totals=state[do["totals"], :t].repeat(
        shards, 1).contiguous())


# ----------------------------------------------------------------------
# the plain versions
def solve_sharded_plain(params: SolverParams, ss: SStatic, sstate: SState,
                        pod_ints: torch.Tensor, pod_floats: torch.Tensor
                        ) -> torch.Tensor:
    """The reference's sharded scan as a per-pod loop of tensor operations
    over the ``S`` column slices (S = the rows of ``sstate.totals``).
    Updates the planes (but their totals row) and the shards' totals in
    place; returns each pod row's node, -1 for none. Terms a pod does not
    reference are skipped (adding zero changes nothing)."""
    r, scn, tn, v, svn = ss.r, ss.sc, ss.t, ss.v, ss.sv
    shards = sstate.totals.shape[0]
    so, _ = static_planes(r, scn, tn, ss.u)
    do, _ = state_planes(r, scn, tn, svn)
    c = _pod_columns(r, scn, tn)
    ints, planes, dev = ss.ints, sstate.planes, ss.ints.device
    n = ints.shape[1]
    nl = n // shards
    bw, lw, sw, aw, stw = params.as_tuple()

    node_valid = ints[so["node_valid"]] > 0
    max_pods = ints[so["max_pods"]]
    alloc = ints[so["alloc"]:so["alloc"] + r]
    alloc_cpu = torch.clamp(alloc[0], min=1).to(torch.float32)
    alloc_mem = torch.clamp(alloc[1], min=1).to(torch.float32)
    sc_codes = ints[so["sc_codes"]:so["sc_codes"] + scn]
    term_codes = ints[so["term_codes"]:so["term_codes"] + tn]
    codes = torch.cat([sc_codes, term_codes])                 # [SC+T, N]
    t_real = term_codes < v
    gidx = torch.arange(n, dtype=torch.int64, device=dev).view(shards, nl)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=dev)
    max_skew = ss.sc_meta[0].tolist()
    hard = (ss.sc_meta[1] > 0).tolist()
    has_dom = ss.has_dom.tolist()
    totals = sstate.totals.tolist()                           # [S][T]
    mb, oa, oan = c["match_by"], c["own_aff"], c["own_anti"]
    out = []
    for row, wrow in zip(pod_ints.tolist(), pod_floats.tolist()):
        if row[c["valid"]] <= 0:     # every column infeasible: no offer
            out.append(-1)
            continue
        refs = [(k, row[mb + k] > 0, row[oa + k] > 0, row[oan + k] > 0,
                 wrow[k]) for k in range(tn)
                if row[mb + k] or row[oa + k] or row[oan + k]
                or wrow[k] != 0.0]
        profile = row[c["profile"]]
        # ---- each shard's filter, on its own columns
        feasible = node_valid & (planes[do["pod_count"]] < max_pods)
        for ri in range(r):
            feasible &= planes[do["requested"] + ri] + row[ri] <= alloc[ri]
        feasible &= ints[so["masks"] + profile] > 0
        slot = row[c["sv"]] if svn else svn
        if slot < svn:
            col = row[c["sv"] + 1]
            demand = 1 - planes[do["sv_attached"] + slot]
            feasible &= (planes[do["requested"] + col] + row[col] + demand
                         <= alloc[col])
        for sci in range(scn):
            if row[c["pod_sc"] + sci] > 0 and hard[sci]:
                counts = planes[do["sc_counts"] + sci]
                dom = ints[so["sc_domain"] + profile * scn + sci] > 0
                # each shard's minimum, then the least of them (the pmin)
                lmin = torch.where(dom, counts, BIG).view(shards, nl).amin(1)
                min_c = int(lmin.min()) if has_dom[profile][sci] else 0
                skew = counts + int(row[c["sc_match"] + sci] > 0) - min_c
                feasible &= (sc_codes[sci] < v) & (skew <= max_skew[sci])
        has_aff, self_all = False, True
        for ti, matched, aff, anti, _ in refs:
            if matched:
                feasible &= planes[do["term_owners"] + ti] <= 0
            if anti:
                feasible &= planes[do["term_counts"] + ti] <= 0
            if aff:
                has_aff = True
                self_all &= matched
        if has_aff:
            # the first-pod rule reads each shard's own totals
            aff_sat = torch.ones(n, dtype=torch.bool, device=dev)
            for ti, _, aff, _, _ in refs:
                if aff:
                    aff_sat &= (planes[do["term_counts"] + ti] > 0) \
                        & t_real[ti]
            no_any = torch.tensor(
                [all(totals[s][ti] == 0 for ti, _, aff, _, _ in refs if aff)
                 for s in range(shards)], device=dev)
            first = (no_any & self_all)[:, None].expand(shards, nl)
            feasible &= aff_sat | first.reshape(n)
        # ---- scores
        cpu_frac = (planes[do["nonzero"]] + row[c["nonzero"]]).to(
            torch.float32) / alloc_cpu
        mem_frac = (planes[do["nonzero"] + 1] + row[c["nonzero"] + 1]).to(
            torch.float32) / alloc_mem
        over = (cpu_frac >= 1.0) | (mem_frac >= 1.0)
        balanced = torch.where(
            over, 0.0, (1.0 - torch.abs(cpu_frac - mem_frac)) * 100.0)
        least = (torch.clamp(1.0 - cpu_frac, 0.0, 1.0)
                 + torch.clamp(1.0 - mem_frac, 0.0, 1.0)) * 50.0
        soft_counts = torch.zeros(n, dtype=torch.float32, device=dev)
        any_soft = False
        for sci in range(scn):
            if row[c["pod_sc"] + sci] > 0 and not hard[sci]:
                soft_counts += planes[do["sc_counts"] + sci].to(torch.float32)
                any_soft = True
        if any_soft:
            # a tensor numerator: one IEEE division, as the reference's
            spread = torch.div(hundred, 1.0 + soft_counts)
        else:
            spread = torch.zeros(n, dtype=torch.float32, device=dev)
        pref = torch.zeros(n, dtype=torch.float32, device=dev)
        for ti, _, _, _, w in refs:
            if w != 0.0:
                pref += w * planes[do["term_counts"] + ti].to(torch.float32)
        score = (bw * balanced + lw * least + sw * spread + aw * pref
                 + stw * ss.f32s[profile])
        score = torch.where(feasible, score, NEG_INF).view(shards, nl)
        # ---- each shard's offer: its best score, the lowest global index
        # at that score, that column's codes (the [S, 2+SC+T] block)
        lmax = score.amax(1)
        lcand = torch.where(feasible.view(shards, nl)
                            & (score >= lmax[:, None]), gidx, BIG).amin(1)
        offer_codes = torch.where(
            (lcand < BIG)[None, :], codes[:, lcand.clamp(max=n - 1)], 0)
        # ---- the block's resolution: the best score, found above
        # NEG_INF / 2, the lowest index among the shards at that score
        gmx = lmax.max()
        if not bool(gmx > NEG_INF / 2):
            out.append(-1)
            continue
        cand_sel = torch.where(lmax >= gmx, lcand, BIG)
        wshard = int(torch.argmin(cand_sel))
        chosen = int(cand_sel[wshard])
        code_j = offer_codes[:, wshard].tolist()
        out.append(chosen)
        # ---- each shard commits to its own columns
        for ri in range(r):
            planes[do["requested"] + ri, chosen] += row[ri]
        planes[do["nonzero"], chosen] += row[c["nonzero"]]
        planes[do["nonzero"] + 1, chosen] += row[c["nonzero"] + 1]
        planes[do["pod_count"], chosen] += 1
        if slot < svn:
            planes[do["requested"] + col, chosen] += demand[chosen]
            planes[do["sv_attached"] + slot, chosen] = 1
        for sci in range(scn):
            if row[c["sc_match"] + sci] > 0:
                planes[do["sc_counts"] + sci] += (
                    sc_codes[sci] == code_j[sci]).to(torch.int32)
        for ti, matched, _, anti, _ in refs:
            same = (term_codes[ti] == code_j[scn + ti]).to(torch.int32)
            if matched:
                planes[do["term_counts"] + ti] += same
                if code_j[scn + ti] < v:
                    for s in range(shards):
                        totals[s][ti] += 1
            if anti:
                planes[do["term_owners"] + ti] += same
    sstate.totals.copy_(torch.tensor(totals, dtype=torch.int32,
                                     device=dev).view(shards, tn))
    return torch.tensor(out, dtype=torch.int32, device=dev)


def feasible_counts_plain(ss: SStatic, pod_ints: torch.Tensor, shards: int,
                          batch_axis: int = 1) -> torch.Tensor:
    """The reference's batched static feasibility: per pod, the nodes that
    are valid, in its profile's static mask and fit its requests, counted
    on each (batch slice, node shard) tile and summed over the shards."""
    r, u = ss.r, ss.u
    so, _ = static_planes(r, ss.sc, ss.t, u)
    ints = ss.ints
    n, b = ints.shape[1], pod_ints.shape[0]
    if n % shards != 0 or b % batch_axis != 0:
        raise ValueError(f"{b} pods x {n} nodes do not split over a "
                         f"{batch_axis} x {shards} mesh")
    nl, per = n // shards, b // batch_axis
    alloc = ints[so["alloc"]:so["alloc"] + r]
    masks = ints[so["masks"]:so["masks"] + u] > 0
    node_ok = ints[so["node_valid"]] > 0
    out = torch.zeros(b, dtype=torch.int32, device=ints.device)
    for a in range(batch_axis):
        pods = pod_ints[a * per:(a + 1) * per]
        reqs = pods[:, :r]
        profiles = pods[:, r + 2].long()
        for s in range(shards):
            cols = slice(s * nl, (s + 1) * nl)
            fit = (reqs[:, :, None] <= alloc[None, :, cols]).all(dim=1)
            both = fit & masks[profiles][:, cols] & node_ok[None, cols]
            out[a * per:(a + 1) * per] += both.sum(dim=1, dtype=torch.int32)
    return out


# ----------------------------------------------------------------------
# the wrappers: the plain version on the CPU, the kernel on the card
def solve_sharded(params: SolverParams, ss: SStatic, sstate: SState,
                  pod_ints: torch.Tensor, pod_floats: torch.Tensor
                  ) -> torch.Tensor:
    """Solve one batch over the shards: the plain version on CPU tensors,
    ``solve_sharded_kernel`` on CUDA tensors (waiting for its exchange's
    error word, which raises)."""
    dev = sstate.planes.device
    if dev.type == "cpu":
        return solve_sharded_plain(params, ss, sstate, pod_ints, pod_floats)
    if dev.type == "cuda":
        assign, err = solve_mod.solve_kernel.launch_sharded(
            params, ss, sstate.planes, sstate.totals, pod_ints, pod_floats)
        solve_mod.check_exchange(int(err[0]))
        return assign
    raise ValueError(f"no sharded solve for device {dev}")


def feasible_counts(ss: SStatic, pod_ints: torch.Tensor, mesh: Mesh
                    ) -> torch.Tensor:
    """The per-pod feasibility counts over the mesh: the plain version on
    CPU tensors, ``feasible_counts_kernel`` on CUDA tensors. The caller
    checks the profile indices on the host (as ``solve_scan_sharded``
    does), so nothing waits for the card."""
    shards, batch_axis = mesh.shape["nodes"], mesh.shape["batch"]
    if pod_ints.device.type == "cpu":
        return feasible_counts_plain(ss, pod_ints, shards, batch_axis)
    if pod_ints.device.type == "cuda":
        return solve_mod.solve_kernel.launch_counts(
            ss, pod_ints, shards, batch_axis, profiles=False)
    raise ValueError(f"no feasibility counts for device {pod_ints.device}")


def solve_scan_sharded(cluster: EncodedCluster, batch: EncodedBatch,
                       mesh: Mesh, params: SolverParams = SolverParams()
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The sharded solve of one encoded batch on the mesh's device:
    (assignments [B] global node indices, feasible counts [B]). The pods'
    profile indices and volume references are checked on the host before
    anything is uploaded."""
    pod_ints, pod_floats = pack_podin(batch)
    if pod_ints.shape[0] % mesh.shape["batch"] != 0:
        raise ValueError(
            f"padded batch size {pod_ints.shape[0]} not divisible by mesh "
            f"batch axis {mesh.shape['batch']}")
    r, sc = cluster.allocatable.shape[1], batch.sc_counts.shape[0]
    sv = 0 if cluster.sv_attached is None else cluster.sv_attached.shape[0]
    check_profiles(pod_ints[:, r + 2], batch.static_masks.shape[0])
    check_sv(pod_ints, r, sc, batch.term_counts.shape[0], sv)
    ss, sstate = _prepare_sharded(cluster, batch, mesh)
    ints = torch.from_numpy(pod_ints).to(mesh.device)
    floats = torch.from_numpy(pod_floats).to(mesh.device)
    counts = feasible_counts(ss, ints, mesh)
    assign = solve_sharded(params, ss, sstate, ints, floats)
    return assign.cpu().numpy(), counts.cpu().numpy()


# ----------------------------------------------------------------------
def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ShardedBackend(CudaPlanesBackend):
    """The session's backend over a mesh: the ``CudaPlanesBackend``
    contract (prepare, state-only prepare, lazy solve, materialize,
    scatters, timing events, transfer counts) on sharded planes, every
    batch on ``solve_sharded_kernel`` (the plain version on the CPU).

    ``donate`` (the default) keeps the planes resident on the device from
    batch to batch; ``donate=False`` is the staging arm: every solve
    first reads the carried planes and totals back to the host and
    uploads them again, synchronously, and counts those bytes as d2h and
    h2d.
    ``encode_shards`` splits the encoder's node-column fill along the
    mesh's shards. The mirror's scatters land on the owning shard's
    columns, as ``index_put_`` into the same planes."""

    name = "sharded"

    def __init__(self, mesh: Optional[Mesh] = None, donate: bool = True):
        self.mesh = mesh or make_mesh()
        super().__init__(self.mesh.device)
        self.donate = donate
        self.encode_shards = int(self.mesh.shape["nodes"])

    def prepare(self, cluster, batch) -> Tuple[SStatic, SState]:
        ss, sstate = _prepare_sharded(cluster, batch, self.mesh)
        self.transfer["h2d"] += _nbytes(ss.ints, ss.f32s, ss.sc_meta,
                                        ss.has_dom, *sstate)
        return ss, sstate

    def prepare_state_only(self, cluster, batch) -> SState:
        """The state planes and totals alone: the static planes of the
        same fingerprint stay resident."""
        sstate = _host_state_planes(cluster, batch, self.encode_shards,
                                    self.device)
        self.transfer["h2d"] += _nbytes(*sstate)
        return sstate

    @staticmethod
    def warm_state(sstate: SState) -> SState:
        """A copy of the carried state for a warm solve to consume."""
        return SState(sstate.planes.clone(), sstate.totals.clone())

    def _stage(self, sstate: SState) -> None:
        """The staging arm: the carried planes and totals to the host and
        back, before the solve."""
        for tensor in sstate:
            tensor.copy_(tensor.cpu())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        nbytes = _nbytes(*sstate)
        self.transfer["d2h"] += nbytes
        self.transfer["h2d"] += nbytes

    def solve_lazy(self, params: SolverParams, ss: SStatic, sstate: SState,
                   pod_ints: np.ndarray, pod_floats: np.ndarray
                   ) -> SolveHandle:
        """Upload the pod stream and start the sharded solve, which updates
        the planes and the shards' totals in place; the assignments come
        back through ``materialize``, which raises on an exchange error."""
        check_profiles(pod_ints[:, ss.r + 2], ss.u)
        check_sv(pod_ints, ss.r, ss.sc, ss.t, ss.sv)
        if not self.donate:
            self._stage(sstate)
        ints, ints_slot = self._upload(pod_ints)
        floats, floats_slot = self._upload(pod_floats)
        if self.device.type == "cpu":
            assign = solve_sharded_plain(params, ss, sstate, ints, floats)
            self.solves += 1
            return SolveHandle(assign, assign, None, time.monotonic())
        started = torch.cuda.Event(enable_timing=True)
        ended = torch.cuda.Event(enable_timing=True)
        started.record()
        assign, err = solve_mod.solve_kernel.launch_sharded(
            params, ss, sstate.planes, sstate.totals, ints, floats)
        ended.record()
        self.solves += 1
        host, host_slot = self.staging.take(assign.shape, assign.dtype,
                                            readback=True)
        host.copy_(assign, non_blocking=True)
        err_host, err_slot = self.staging.take(err.shape, err.dtype,
                                               readback=True)
        err_host.copy_(err, non_blocking=True)
        event = self._fence((ints_slot, floats_slot, host_slot, err_slot))
        return SolveHandle(assign, host, event, time.monotonic(), started,
                           ended, err_host)

    def materialize(self, handle: SolveHandle) -> np.ndarray:
        """Wait for the handle's batch and return its assignments; raises
        when the kernel's exchange failed."""
        out = super().materialize(handle)
        if handle.err is not None:
            solve_mod.check_exchange(int(handle.err[0]))
        return out

    def scatter_state_add(self, sstate: SState, rows: np.ndarray,
                          cols: np.ndarray, vals: np.ndarray) -> int:
        """Add ``vals`` at (rows, cols) of the planes, each entry on the
        shard owning its column, in place; the totals are not planes the
        mirror writes. Returns the bytes the entries took to the device."""
        return super().scatter_state_add(sstate.planes, rows, cols, vals)
