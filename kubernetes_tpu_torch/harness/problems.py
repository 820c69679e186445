"""Seeded solve problems made directly in the planes layout, at any node
count and constraint width, for holding the solve kernels against their
plain version (``tests/test_torch_cuda.py``, ``chip_smoke.py``), with
the feasibility counts kernel's own cases (``counts_cases``); and
seeded what-if problems for the legacy scan (``whatif_problem``) with
the cases its kernel is held against (``scan_cases``).

The planes are consistent the way the encoder makes them: topology counts
are per domain value (every column of a domain holds its count), the
sentinel value ``v`` marks a node without the key, the eligible domains of
a profile exclude the sentinel, and the totals are the real-value sums of
the term counts. With shared-volume slots (``sv``), the last resource is an
attach-limit column, as the encoder appends one: small limits, in-use counts
clamped to them (some nodes full), and attached bits clear on full nodes."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.autoscaler.nodegroups import NodeGroup
from kubernetes_tpu_torch.autoscaler.simulator import (
    UPCOMING_NODE_PENALTY,
    VIRTUAL_COLUMN_STEP,
    encode_whatif,
)
from kubernetes_tpu_torch.federation.ledger import CapacityLedger
from kubernetes_tpu_torch.federation.scheduler import (
    GANG_NAME_LABEL,
    REMOTE_CLUSTER_PENALTY,
    SATURATION_PENALTY,
    FederationPolicy,
    FederationScheduler,
    group_units,
)
from kubernetes_tpu_torch.harness.burst import make_burst_pods
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.planes import PStatic, state_planes, static_planes
from kubernetes_tpu_torch.ops.slots import SPARSE_K
from kubernetes_tpu_torch.ops import solver
from kubernetes_tpu_torch.ops.solver import VIRTUAL_NODE_PENALTY
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot


def random_planes(seed: int, n: int, b: int, r: int = 3, sc: int = 1,
                  t: int = 1, u: int = 1, v: int = 10, real: int = None,
                  sv: int = 0) -> Tuple[PStatic, torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(static planes, state, pod ints, pod floats) on the CPU: ``n``
    columns of which the first ``real`` (all by default) are nodes, ``b``
    pod rows (about one in eight padding), ``v`` topology values, and
    ``sv`` shared-volume slots (then ``r`` is at least 4): about three in
    four pods reference one of the first ``sv // 2 + 1`` slots, so later
    pods of the batch reuse volumes earlier ones attached, and one in five
    also requests a non-shared attachment."""
    rng = np.random.default_rng(seed)
    real = n if real is None else real
    so, cs = static_planes(r, sc, t, u)
    do, cd = state_planes(r, sc, t, sv)

    ints = np.zeros((cs, n), dtype=np.int32)
    alloc = rng.integers(4000, 32000, (r, n))
    ints[so["alloc"]:so["alloc"] + r] = alloc
    ints[so["max_pods"]] = rng.integers(8, 110, n)
    ints[so["masks"]:so["masks"] + u] = rng.random((u, n)) < 0.9
    sc_codes = rng.integers(0, v + 1, (sc, n))
    ints[so["sc_codes"]:so["sc_codes"] + sc] = sc_codes
    eligible = rng.random((u, sc, v + 1)) < 0.8
    eligible[:, :, v] = False
    dom = np.take_along_axis(eligible, np.broadcast_to(sc_codes, (u, sc, n)),
                             axis=2)
    ints[so["sc_domain"]:so["sc_domain"] + u * sc] = dom.reshape(u * sc, n)
    term_codes = rng.integers(0, v + 1, (t, n))
    ints[so["term_codes"]:so["term_codes"] + t] = term_codes
    ints[so["node_valid"], :real] = 1
    f32s = rng.integers(0, 100, (u, n)).astype(np.float32)
    sc_meta = np.stack([rng.integers(1, 3, sc),
                        rng.integers(0, 2, sc)]).astype(np.int32)

    state = np.zeros((cd, n), dtype=np.int32)
    req = (alloc * rng.random((r, n)) * 0.6).astype(np.int32)
    state[do["requested"]:do["requested"] + r] = req
    state[do["nonzero"]:do["nonzero"] + 2] = req[:2]
    state[do["pod_count"]] = rng.integers(0, 6, n)
    by_value = rng.integers(0, 4, (sc, v + 1))
    state[do["sc_counts"]:do["sc_counts"] + sc] = np.take_along_axis(
        by_value, sc_codes, axis=1)
    term_counts = rng.integers(0, 3, (t, v + 1)) * (rng.random((t, v + 1))
                                                    < 0.3)
    state[do["term_counts"]:do["term_counts"] + t] = np.take_along_axis(
        term_counts, term_codes, axis=1)
    owners = rng.random((t, v + 1)) < 0.1
    state[do["term_owners"]:do["term_owners"] + t] = np.take_along_axis(
        owners, term_codes, axis=1)
    state[do["totals"], :t] = term_counts[:, :v].sum(axis=1)

    def flags(shape, p):
        return (rng.random(shape) < p).astype(np.int32)

    pod_req = rng.integers(100, 2500, (b, r))
    pod_sv = []
    if sv:
        if r < 4:
            raise ValueError("shared-volume slots need an attach column "
                             "after cpu, memory and ephemeral storage")
        col = r - 1
        limit = rng.integers(1, 5, n)
        ints[so["alloc"] + col] = limit
        in_use = np.minimum(rng.integers(0, 5, n), limit)
        state[do["requested"] + col] = in_use
        full = in_use >= limit
        state[do["sv_attached"]:do["sv_attached"] + sv] = (
            (rng.random((sv, n)) < 0.1) & ~full)
        pod_req[:, col] = rng.random(b) < 0.2
        shared = rng.random(b) < 0.75
        slot = np.where(shared, rng.integers(0, sv // 2 + 1, b), sv)
        pod_sv = [np.stack([slot, np.where(shared, col, 0)], axis=1)]
    pod_ints = np.concatenate([
        pod_req, pod_req[:, :2],
        rng.integers(0, u, (b, 1)),             # profile
        flags((b, 1), 0.875),                   # valid
        flags((b, sc), 0.3),                    # pod_sc
        flags((b, sc), 0.5),                    # sc_match
        flags((b, t), 0.15),                    # match_by
        flags((b, t), 0.05),                    # own_aff
        flags((b, t), 0.05),                    # own_anti
        *pod_sv,                                # slot, attach column
    ], axis=1).astype(np.int32)
    pod_floats = (rng.integers(-3, 8, (b, t)) * flags((b, t), 0.2)
                  ).astype(np.float32)
    pstatic = PStatic(torch.from_numpy(ints), torch.from_numpy(f32s),
                      torch.from_numpy(sc_meta), r, sc, t, u, v, sv)
    return (pstatic, torch.from_numpy(state), torch.from_numpy(pod_ints),
            torch.from_numpy(pod_floats))


def counts_planes(seed: int, n: int, b: int, r: int = 3, u: int = 2,
                  mask_p: float = 0.6) -> Tuple[PStatic, torch.Tensor]:
    """(static planes, pod ints) for the feasibility counts: ``random_planes``
    with each profile's mask drawn at ``mask_p`` and the requests drawn from
    the alloc rows' own range, so each resource fits about half the nodes
    and the counts vary from pod to pod."""
    ps, _, ints, _ = random_planes(seed, n, b, r=r, u=u)
    rng = np.random.default_rng(seed + 1000)
    so, _ = static_planes(r, ps.sc, ps.t, u)
    ps.ints[so["masks"]:so["masks"] + u] = torch.from_numpy(
        (rng.random((u, n)) < mask_p).astype(np.int32))
    ints[:, :r] = torch.from_numpy(
        rng.integers(0, 24000, (b, r)).astype(np.int32))
    return ps, ints


def counts_cases() -> List[Tuple[str, PStatic, torch.Tensor, Tuple[int, ...],
                                 Tuple[int, ...]]]:
    """Seeded problems for the feasibility counts kernel: (name, planes,
    pod ints, node shard counts, batch axes). A batch that is no multiple
    of the kernel's 32-pod tile, one pod (a batch axis of 1 only: one pod
    does not split), 128 and 65,536 columns, three profiles drawn apart,
    no valid node, pods that fit nowhere (a request past every node's
    alloc), one resource and six (past the four the kernel keeps in
    registers), and 81,920 pods: more tiles than a cluster's chunk of 16
    where the card holds at most 132 clusters."""
    out = [("counts-ragged-4002", *counts_planes(60, 5120, 4002), (1, 2, 4),
            (1, 2)),
           ("counts-one-pod", *counts_planes(61, 1024, 1), (1, 2, 4), (1,)),
           ("counts-128", *counts_planes(62, 128, 96), (1, 2, 4), (1, 2)),
           ("counts-65536", *counts_planes(63, 65536, 256), (1, 2, 4),
            (1, 2))]
    ps, ints = counts_planes(64, 2048, 512, u=3)
    so, _ = static_planes(ps.r, ps.sc, ps.t, ps.u)
    for p, frac in enumerate((0.9, 0.4, 0.05)):
        ps.ints[so["masks"] + p] = torch.from_numpy((np.random.default_rng(
            64 + p).random(2048) < frac).astype(np.int32))
    ints[:, ps.r + 2] = torch.arange(512, dtype=torch.int32) % 3
    out.append(("counts-three-profiles", ps, ints, (1, 2, 4), (1, 2)))
    ps, ints = counts_planes(65, 2048, 256)
    ps.ints[static_planes(ps.r, ps.sc, ps.t, ps.u)[0]["node_valid"]] = 0
    out.append(("counts-no-valid-node", ps, ints, (1, 2, 4), (1, 2)))
    ps, ints = counts_planes(66, 2048, 256)
    ints[::3, 1] = 10 ** 9
    out.append(("counts-fit-nowhere", ps, ints, (1, 2, 4), (1, 2)))
    for r in (1, 6):
        out.append((f"counts-r{r}", *counts_planes(66 + r, 3072, 320, r=r),
                    (1, 2, 4), (1, 2)))
    out.append(("counts-chunks-81920", *counts_planes(69, 5120, 81920),
                (1, 4), (1, 2)))
    return out


def random_slot_planes(seed: int, n: int, b: int, t: int, r: int = 3,
                       sc: int = 1, u: int = 1, v: int = 10,
                       real: int = None) -> Tuple[PStatic, torch.Tensor,
                                                  torch.Tensor, torch.Tensor]:
    """``random_planes`` with each pod referencing at most ``SPARSE_K``
    of the ``t`` terms, so the batch packs into slots: matched, required
    affinity or anti-affinity and preferred weights of either sign,
    several a pod. The first two terms start with no pod matching them,
    and every eighth pod requires affinity to one of them and matches it:
    the first such pod of a group passes anywhere (the first-pod rule),
    the next ones must join its domain."""
    ps, state, ints, floats = random_planes(seed, n, b, r=r, sc=sc, t=t,
                                            u=u, v=v, real=real)
    rng = np.random.default_rng(seed + 7919)
    groups = 2
    do, _ = state_planes(r, sc, t)
    state[do["term_counts"]:do["term_counts"] + groups] = 0
    state[do["totals"], :groups] = 0
    c = r + 4 + 2 * sc
    mb, oa, oan = (ints[:, c + i * t:c + (i + 1) * t] for i in range(3))
    ints[:, c:] = 0
    floats[:] = 0
    weights = np.array([-5, -3, -1, 1, 2, 4, 7], dtype=np.float32)
    for i in range(b):
        if i % 8 == 0:
            k = int(rng.integers(groups))
            mb[i, k] = oa[i, k] = 1
            continue
        for k in rng.choice(t, int(rng.integers(0, SPARSE_K + 1)),
                            replace=False):
            mb[i, k] = rng.random() < 0.5
            oa[i, k] = rng.random() < 0.1
            oan[i, k] = rng.random() < 0.15
            if rng.random() < 0.6 or not (mb[i, k] | oa[i, k] | oan[i, k]):
                floats[i, k] = float(rng.choice(weights))
    return ps, state, ints, floats


def cache_slot_planes(seed: int, n: int, b: int, t: int, chunk: int,
                      r: int = 3, sc: int = 1, u: int = 1, v: int = 10,
                      real: int = None) -> Tuple[PStatic, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
    """``random_planes`` with a pod stream that packs into slots and works
    the slot kernel's term-row cache at its pod ``chunk``: every pod
    references ``SPARSE_K`` terms, two of them the previous pod's (which
    that pod matched, so its commit counted them, and which this pod
    weighs or is anti-affine to, so it reads those counts) and the rest
    fresh, so a chunk references ``6 * chunk + 2`` terms and the batch
    walks through all ``t`` of them (more than the cache holds, so lines
    are evicted); every fourth chunk references the terms of the chunk
    three before it again (held by lines that the two chunks between
    evicted in part)."""
    ps, state, ints, floats = random_planes(seed, n, b, r=r, sc=sc, t=t,
                                            u=u, v=v, real=real)
    rng = np.random.default_rng(seed + 104729)
    c = r + 4 + 2 * sc
    ints[:, c:] = 0
    floats[:] = 0
    fresh = SPARSE_K - 2
    span = fresh * chunk + 2            # the terms a chunk references
    weights = np.array([-5, -3, -1, 1, 2, 4, 7], dtype=np.float32)
    for i in range(b):
        x, q = divmod(i, chunk)
        block = x - 3 if x % 4 == 3 else x
        start = block * span + fresh * q
        for m in range(SPARSE_K):
            k = (start + m) % t
            if m >= fresh:              # shared with the next pod
                ints[i, c + k] = 1
                continue
            if m < 2 and q > 0:         # the previous pod counted it
                if rng.random() < 0.2:
                    ints[i, c + 2 * t + k] = 1
                else:
                    floats[i, k] = float(rng.choice(weights))
                continue
            kind = rng.random()
            if kind < 0.4:
                ints[i, c + k] = 1
            elif kind < 0.45:
                ints[i, c + t + k] = ints[i, c + k] = 1
            elif kind < 0.55:
                ints[i, c + 2 * t + k] = 1
            if kind >= 0.3:
                floats[i, k] = float(rng.choice(weights))
    return ps, state, ints, floats


# ----------------------------------------------------------------------
# seeded what-if problems for the legacy scan (``ops/solver.py``)
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


# the pending pods' kinds, drawn uniformly (None: a plain pod)
WHATIF_KINDS = (None, None, "hard", "soft", "affinity", "anti", "preferred")


def whatif_problem(seed: int, n_nodes: int = 40, n_bound: int = 60,
                   n_pods: int = 200, n_upcoming: int = 8,
                   n_virtual: int = 16, n_disabled: int = 2,
                   host_key: bool = True, pad: int = 256,
                   kinds=WHATIF_KINDS):
    """(cluster, batch, penalties, disabled columns): a seeded cluster of
    small nodes (more pending pods than they hold) over six zones (one node without a zone label) with bound pods,
    ``n_pods`` pending pods mixing hard and soft zone spread, hostname
    spread and anti-affinity when ``host_key`` (so V = N), required zone
    affinity, preferred (anti-)affinity weights and plain pods, padded to
    ``pad`` rows (``kinds``: the kinds drawn, of ``WHATIF_KINDS``);
    ``n_upcoming`` + ``n_virtual`` template nodes appended
    as extra columns with the autoscaler's graded penalty tiers, and
    ``n_disabled`` real columns disabled. Encoded by the port's encoder
    (numpy arrays, as the reference's)."""
    rng = np.random.default_rng(seed)

    def node(name, cpu, zone):
        labels = {HOST: name}
        if zone is not None:
            labels[ZONE] = f"z{zone}"
        return Node.from_dict({"metadata": {"name": name, "labels": labels},
                               "status": {"capacity": {
                                   "cpu": str(cpu), "memory": "16Gi",
                                   "pods": "16"}}})

    def term(app, key):
        return {"labelSelector": {"matchLabels": {"app": app}},
                "topologyKey": key}

    def pod(name, app, node_name="", kind=None):
        spec = {"containers": [{"name": "c", "resources": {"requests": {
            "cpu": f"{int(rng.choice([250, 500, 1000]))}m",
            "memory": f"{int(rng.choice([256, 512, 1024]))}Mi"}}}]}
        if node_name:
            spec["nodeName"] = node_name
        keys = [ZONE, HOST] if host_key else [ZONE]
        if kind == "hard":
            spec["topologySpreadConstraints"] = [{
                "maxSkew": int(rng.integers(1, 3)),
                "topologyKey": str(rng.choice(keys)),
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": app}}}]
        elif kind == "soft":
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1, "topologyKey": str(rng.choice(keys)),
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": app}}}]
        elif kind == "affinity":
            spec["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    term(f"a{int(rng.integers(3))}", ZONE)]}}
        elif kind == "anti":
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    term(app, str(rng.choice(keys)))]}}
        elif kind == "preferred":
            spec["affinity"] = {
                "podAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": int(rng.integers(1, 100)),
                        "podAffinityTerm": term(f"a{int(rng.integers(3))}",
                                                str(rng.choice(keys)))}]},
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": int(rng.integers(1, 100)),
                        "podAffinityTerm": term(app, ZONE)}]}}
        return Pod.from_dict({"metadata": {"name": name, "uid": f"u-{name}",
                                           "labels": {"app": app}},
                              "spec": spec})

    nodes = [node(f"n{i}", int(rng.choice([1, 2, 4])),
                  None if i == n_nodes - 1 else i % 6)
             for i in range(n_nodes)]
    bound = [pod(f"b{i}", f"a{int(rng.integers(3))}",
                 f"n{int(rng.integers(n_nodes))}") for i in range(n_bound)]
    pending = [pod(f"p{i}", f"a{int(rng.integers(3))}",
                   kind=kinds[int(rng.integers(len(kinds)))])
               for i in range(n_pods)]
    extra = [node(f"x{i}", 8, i % 6) for i in range(n_upcoming + n_virtual)]
    enc = BatchEncoder(new_snapshot(bound, nodes), extra_nodes=extra)
    cluster, batch = enc.encode(pending, pad_pods=pad)
    base = enc.num_snapshot_nodes
    cap = float(VIRTUAL_NODE_PENALTY) - VIRTUAL_COLUMN_STEP
    penalties = {base + j: min(UPCOMING_NODE_PENALTY
                               + j * VIRTUAL_COLUMN_STEP, cap)
                 for j in range(n_upcoming)}
    penalties.update({base + n_upcoming + j: float(VIRTUAL_NODE_PENALTY)
                      + j * VIRTUAL_COLUMN_STEP for j in range(n_virtual)})
    disabled = [int(c) for c in rng.choice(n_nodes, n_disabled,
                                           replace=False)]
    return cluster, batch, penalties, disabled


def autoscale_whatif():
    """The autoscale row's largest what-if shape, as ``run_whatif``
    encodes it: 94 full nodes of 32 cpu (64 bound pods of 500m each),
    162 booting and 256 new nodes of the group's template, 2,048 pending
    pods of 500m; N = 512, no constraints. (cluster, batch, penalties,
    disabled columns)."""
    group = NodeGroup("ng-elastic", cpu="32", memory="64Gi")
    nodes = [group.node_template(i) for i in range(94)]
    bound = make_burst_pods(94 * 64, name_prefix="b-", uid_prefix="bu-")
    for i, pod in enumerate(bound):
        pod.spec.node_name = nodes[i // 64].name
    pending = make_burst_pods(2048, name_prefix="p-", uid_prefix="pu-")
    return encode_whatif(
        nodes, bound, pending,
        upcoming_nodes=[group.node_template(94 + i) for i in range(162)],
        new_nodes=[group.node_template(256 + i) for i in range(256)],
        pad_pods=2048)[:4]


def federation_whatif(seed: int, clusters: int = 3, units: int = 40,
                      remote=(), saturated=(), disabled=(), pad: int = 64):
    """A federation decision's what-if, as ``FederationScheduler``
    encodes it: one column per cluster (a seeded remaining capacity of
    2-64 cpu and 8-256 GiB), ``units`` seeded pods of 100m-4 cpu, every
    fifth pair folded into a gang; the remote penalty on the columns in
    ``remote``, the saturation penalty on those in ``saturated`` (both
    where in both, added as the scheduler adds them), ``disabled``
    columns removed. (cluster, batch, penalties, disabled columns)."""
    rng = np.random.default_rng(seed)
    ledger = CapacityLedger()
    for cid in range(clusters):
        ledger.register(cid)
        ledger.refresh_from(cid, [Node.from_dict({
            "metadata": {"name": f"c{cid}-node-0"},
            "status": {"capacity": {
                "cpu": str(int(rng.choice([2, 8, 16, 64]))),
                "memory": f"{int(rng.choice([8, 64, 256]))}Gi",
                "pods": "110"}}})], [])
    pods = []
    for i in range(units):
        labels = {GANG_NAME_LABEL: f"g{i // 2}"} if i % 10 < 2 else {}
        pods.append(Pod.from_dict({
            "metadata": {"name": f"u{i}", "uid": f"fu-{i}",
                         "namespace": f"ns{i % 3}", "labels": labels},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {
                    "cpu": f"{int(rng.choice([100, 500, 1000, 4000]))}m",
                    "memory": f"{int(rng.choice([128, 1024, 4096]))}Mi"}}}]}}))
    fed = FederationScheduler(ledger, policy=FederationPolicy(pad_pods=pad),
                              device="cpu")
    cluster, batch, _ = fed._encode(list(range(clusters)), group_units(pods))
    penalties = {}
    for col in range(clusters):
        pen = 0.0
        if col in remote:
            pen += REMOTE_CLUSTER_PENALTY
        if col in saturated:
            pen += SATURATION_PENALTY
        if pen:
            penalties[col] = pen
    return cluster, batch, penalties, list(disabled)


def federation_cases(seed: int = 0) -> list:
    """(name, what-if, columns) of the federation's tiny column counts:
    one cluster; every column disabled but one; every column disabled
    (every unit unplaced); a column with both the remote and the
    saturation penalty beside a remote one and home. ``columns``: the
    real column count (the encoder pads N to 128)."""
    return [
        ("fed N=1", federation_whatif(seed, clusters=1), 1),
        ("fed N=2, one enabled", federation_whatif(
            seed + 1, clusters=2, disabled=[1]), 2),
        ("fed N=3, one enabled", federation_whatif(
            seed + 2, clusters=3, remote=[0, 2], disabled=[0, 2]), 3),
        ("fed N=3, all disabled", federation_whatif(
            seed + 3, clusters=3, disabled=[0, 1, 2]), 3),
        ("fed N=3, remote and saturated", federation_whatif(
            seed + 4, clusters=3, units=60, remote=[1, 2],
            saturated=[0, 2]), 3),
    ]


class ScanCase(NamedTuple):
    """One input of the scan kernel's card checks: a what-if problem
    (``whatif_problem``'s tuple), cut to its first ``n`` columns and to
    the pod ``rows`` when given, every row made padding when
    ``padding``, and the plan choices ``plan`` forces (``tables``,
    ``cols``)."""

    name: str
    problem: tuple
    n: Optional[int] = None
    rows: Optional[slice] = None
    padding: bool = False
    plan: dict = {}


def scan_cases(seed: int = 0, n_pods: int = 200) -> List[ScanCase]:
    """The cases the scan kernel is held against its plain version on:
    N at 256 x k - 1, 256 x k and 256 x k + 1 for k = 1, 2, 4, 8, so at
    each boundary of the plan's columns a thread (k steps at 512, 1,024
    and 2,048 columns) and at 256 threads; zone
    keys only (V < N, many columns on one code); hard spread only (the
    domain minimum); required affinity, anti-affinity and preferred
    weights only; the tables, the column arrays, and both, forced into
    global memory; B not a multiple of the chunk; a batch that is all
    padding; B = 0; and the federation's what-ifs (``federation_cases``)
    as encoded (N = 128) and cut to their real columns (N = 1-3)."""
    wide = whatif_problem(seed, n_nodes=300, n_bound=400, n_pods=n_pods,
                          n_upcoming=100, n_virtual=1700, pad=n_pods)
    base = whatif_problem(seed + 1, n_pods=n_pods, pad=n_pods)
    cases = [ScanCase(f"N={256 * k + d}", wide, n=256 * k + d)
             for k in (1, 2, 4, 8) for d in (-1, 0, 1)]
    return cases + [
        ScanCase("zone keys", whatif_problem(seed + 2, host_key=False,
                                             n_pods=n_pods, pad=n_pods)),
        ScanCase("hard spread", whatif_problem(
            seed + 3, n_pods=n_pods, pad=n_pods, kinds=("hard",))),
        ScanCase("terms", whatif_problem(
            seed + 4, n_pods=n_pods, pad=n_pods,
            kinds=("affinity", "anti", "preferred"))),
        ScanCase("global tables", base, plan={"tables": False}),
        ScanCase("global columns", base, plan={"cols": False}),
        ScanCase("global tables and columns", base,
                 plan={"tables": False, "cols": False}),
        ScanCase("B=37", base, rows=slice(0, 37)),
        ScanCase("all padding", base, padding=True),
        ScanCase("B=0", base, rows=slice(0, 0)),
    ] + [case for name, problem, cols in federation_cases(seed)
         for case in (ScanCase(name, problem),
                      ScanCase(f"{name} cut", problem, n=cols))]


def scan_case_inputs(case: ScanCase, device):
    """(static, state, pod ints, pod floats) of ``case`` on ``device``,
    as ``ops.solver.scan_inputs`` makes them with the what-if's
    penalties and disabled columns."""
    cluster, batch, pen, dis = case.problem
    scores, valid = solver.whatif_overrides(cluster, batch, pen, dis)
    static, state, ints, floats = solver.scan_inputs(cluster, batch, device,
                                                     scores, valid)
    if case.n is not None:
        cols = slice(0, case.n)
        static = solver.ScanStatic(
            static.allocatable[cols], static.max_pods[cols],
            static.static_masks[:, cols], static.static_scores[:, cols],
            static.sc_codes[:, cols], static.sc_max_skew, static.sc_hard,
            static.sc_domain, static.term_codes[:, cols],
            static.node_valid[cols])
        state = state._replace(requested=state.requested[cols],
                               nonzero_requested=state.nonzero_requested[cols],
                               pod_count=state.pod_count[cols])
    if case.rows is not None:
        ints, floats = ints[case.rows], floats[case.rows]
    if case.padding:
        ints = ints.clone()
        ints[:, static.allocatable.shape[1] + 3] = 0
    return (solver.ScanStatic(*(x.contiguous() for x in static)),
            solver.ScanState(*(x.contiguous() for x in state)),
            ints.contiguous(), floats.contiguous())
