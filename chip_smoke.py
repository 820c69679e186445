"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the solve kernels (the cluster kernel, the slot kernel and the
   one-block kernel) from kubernetes_tpu_torch/csrc with nvcc and print
   ptxas's registers, shared memory and spills for each;
3. hold the kernels against their plain PyTorch version, on the card,
   over seeded problems (the test cases' shapes, forced ties within and
   across the cluster's slices, a ragged last slice, the only feasible
   node in the last slice, two batches carrying state, constraint spaces
   wider than eight, 5,000 nodes x 512 pods with SC, T and U of 16, a
   cluster of eight, and a shape past the cluster's shared memory with a
   pod of nine term references): assignments and state planes must be
   equal. Each case runs on the kernel the launch plan picks, and again
   on the one-block kernel. Then the slot kernel on slot streams (T of
   16 to 100, a ragged last slice, a cluster of eight, two batches
   carrying state) against the plain slot solve, the dense plain solve
   and the one-block kernel; and the shared-volume attach planes on the
   cluster and one-block kernels (SV of 8, 16, 64 and 512, sentinel pods
   mixed in, full nodes, volumes reused within a batch, a cluster of
   eight, a shape past the cluster's shared memory, two batches carrying
   state);
4. the main path: SchedulingBasic, 5,000 nodes / 30,000 pods, batches of
   4,096, through ``run_workload`` on the card, in the default arms
   (pipelined, device mirror on, the latency-budget tuner on). Every pod
   bound, the cluster kernel launched once per solve, the one-block
   kernel and the plain version never;
5. TopologySpreading, 5,000 nodes / 5,000 pods: the same, and zone skew
   at most one;
6. small SchedulingBasic and TopologySpreading runs on the card and on
   the CPU (the plain version) give identical pod -> node maps;
7. time both kernels on the main paths' largest batches and on the
   SchedulingBasic batch cut to 1,024 columns, in turns (one-block,
   cluster, cluster, one-block), with CUDA events around the bare launch
   (the wrapper's input checks outside the window, its whole call timed
   beside it); the cluster kernel on the two largest batches at cluster
   sizes 16, 8, 4 and 2; and the plain version once on each of the two
   largest batches, which must equal the kernels;
8. SchedulingBasic 5,000 / 30,000 in turns, serialized, pipelined,
   pipelined, serialized: the same pods bound to the same nodes in all
   four; each dispatch (``solve_lazy``, host clock, the cyclic GC's
   pauses taken out) under half its kernel's CUDA-event time, and the
   card still busy right after some of them;
9. the churn path (``workloads.churn``: 6 waves of 5,000 pods over 5,000
   nodes, a seeded 10% of the bound pods deleted and 2% of the nodes
   given a new allocatable cpu after each wave, one pod deleted while a
   batch is held) with the mirror on and off: the same bound sets, no
   pod lost, the held batch discarded, catch-ups in the mirror-on run and
   its planes equal to a fresh ``prepare`` after each;
10. the sustained-arrival row (30,000 pods at 5,000 a second, seed 14,
    32-cpu nodes), pipelined and serialized: no pod lost, every arrival
    injected;
11. the Preemption row (``workloads.preemption``: 5,000 nodes of 4 cpu,
    5,000 priority-1 pods of 3 cpu, then 5,000 priority-100 pods of 3
    cpu) in the default arms and again serialized: every measured pod
    bound, exactly one priority-1 pod deleted per measured pod, no other
    pod lost, the same bound pods on the same nodes and the same victims
    in both arms; the host seconds of the preemption screen, the victim
    planner, plan execution and the serial path;
12. the Unschedulable row (5,000 nodes, 1,000 pods whose node selector
    no node matches, their op not waited for, then 10,000 plain pods):
    the 10,000 bound, each of the 1,000 pending with ``PodScheduled=
    False`` and the FitError message built from the static masks, and
    PostFilter run for none;
13. a small Preemption row (50 nodes / 50 / 50) and a small mixed row
    (host-port pods, which take the serial path, among plain ones) on
    the card and on the CPU: the same pod -> node maps and the same
    victims;
14. the GangScheduling row (``workloads.gang_scheduling``: 5,000 nodes,
    30,000 pods in coscheduling gangs of 10 with a hard zone spread of
    skew 5), pipelined and serialized: every pod bound, every gang whole,
    zone skew at most 5, no pod left waiting at Permit and none rejected
    there (no ``PodScheduled=False`` condition), the cluster kernel
    launched once per solve, the same pods on the same nodes in both
    arms; the binding pool's cycles, Permit waits, rebuilds and
    catch-ups;
15. the SchedulingPodAntiAffinity row (5,000 nodes, 1,000 plain pods,
    then 30,000 pods in 100 colours, each with a required hostname
    anti-affinity to its own colour: T = 100): every measured pod bound,
    no node with two measured pods of one colour, each launch on the
    kernel ``plan_launch`` picks for its batch (the slot kernel for every
    T = 100 batch, where the cluster's dense layout outgrows a block's
    shared memory and each pod references one term); on the largest
    batch the slot kernel, the one-block kernel (forced, on the dense
    stream the slots were packed from) and the plain versions timed in
    turns and held against each other;
16. the three other wide-term families at ``bench.py``'s sizes (5,000
    nodes, 5,000 init pods, 1,000 measured): SchedulingPodAffinity and
    SchedulingPreferredPodAffinity (T = 50), SchedulingPreferredPod-
    AntiAffinity (T = 100): every measured pod bound, each required-
    affinity pod in a zone holding a pod of its group, the launches as
    planned, and the slot kernel equal to the plain version on each
    row's largest batch;
17. the four PV rows at ``bench.py``'s sizes: SchedulingInTreePVs,
    SchedulingMigratedInTreePVs and SchedulingCSIPVs at 1,000 nodes / 0 /
    5,000, SchedulingSharedPVs at 1,000 / 0 / 3,000: every measured pod
    bound, no node over its CSINode limit of 39 ``csi.fake.driver``
    volumes, each WaitForFirstConsumer claim bound to a PV of its own,
    the launches as ``plan_launch`` plans them;
18. PreemptionPVs (``workloads.preemption_pvs``: 5,000 nodes / 5,000 /
    5,000, a bound claim on every preemptor), pipelined and serialized:
    every measured pod bound with exactly one victim each, the same bound
    and victim sets in both arms, every claim still bound to its PV;
19. the shared-volume attach planes at size (the fixture of the JAX
    package's shared-volume tests, grown): 1,000 nodes with a CSINode
    limit of 2 for one driver, 300 shared ReadWriteMany CSI claims, 3,000
    pods, ten a claim, in batches of 1,024 on the carried state: every
    pod bound, no node with more than 2 distinct shared volumes, every
    launch the cluster kernel with SV = 512, and after the run the
    carried ``sv`` planes equal to a fresh ``prepare``'s; on the largest
    batch the cluster kernel, the one-block kernel (forced) and the plain
    version timed in turns and held against each other.

20. BASELINE configs 1-3 as named rows: SchedulingBasic at 100 / 0 /
    1,000 and 1,000 / 0 / 10,000, TopologySpreading at 5,000 / 0 /
    30,000 (zone skew at most one);
21. the four families ported last at ``bench.py``'s sizes:
    SchedulingSecrets and SchedulingNodeAffinity at 5,000 / 5,000 /
    1,000, PreferredTopologySpreading at 5,000 / 5,000 / 2,000,
    MixedSchedulingBasePod at 5,000 / 1,000 / 30,000: every pod bound,
    each node-affinity pod in its zone, the launches as planned;
22. the tracer's cost: SchedulingBasic 5,000 / 30,000 pipelined with the
    process tracer and device profiler on, off, off, on (``KTPU_TRACE``
    and ``KTPU_DEVPROF`` off, in process);
23. the latency-budget tuner forced to shrink: SchedulingBasic 5,000 /
    12,000 with the budget cut to 1 us after the warm-up: the pad steps
    down one bucket a batch to 512, 1,024 and 512 warmed by ``warm_pad``
    between cycles before their first solve; the warm-up (cold) books
    the pinned staging buffers, and no pad allocates any after it.

Every row any phase runs (through ``run_workload`` or the sustained
harness; phase 19's batch loop too, which now warms up first) prints its
``telemetry``, ``critical_path`` and ``freshness`` as a ``row {...}``
line, and a row on the card fails on a compile inside a measured cycle
(a library load, a kernel instance's first launch, or the pinned
staging ring's first allocation of a capacity). The rows whose every cycle
follows their warm-up (phases 4, 5, 8, 20, 22, 23) start cold: no kernel
instance counted as launched and the staging ring empty.
Phase 4 also holds the aggregate unattributed share of the sampled pods'
windows to at most 0.05.

Every main-path run (4, 5, 8 to 23) resets the kernels' launch counts
just before and reads them just after; the kernel table sums them.
Before the last line come the scatters' counts and times as JSON, the
kernel table as JSON and the card's name and power limit; the last line
is the JSON ok line.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import (
    CSINode,
    CSINodeDriver,
    Node,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.harness import perf, sustained, workloads
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.harness.problems import (
    random_planes,
    random_slot_planes,
)
from kubernetes_tpu_torch.ops import mirror as mirror_mod
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.planes import (
    PStatic,
    prepare,
    state_planes,
    static_planes,
)
from kubernetes_tpu_torch.ops.slots import SPARSE_K, slot_stream
from kubernetes_tpu_torch.ops.solve import CudaPlanesBackend
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from kubernetes_tpu_torch.sidecar import BatchScheduler

PARAMS = SolverParams()
KERNEL_SOURCE = "kubernetes_tpu_torch/csrc/solve_kernel.cu"
REPLACES = "kubernetes_tpu/ops/pallas_solver.py:225"
# the reference's sparse scan (an XLA program), which it runs instead of its
# Pallas kernel on wide term axes
REPLACES_SPARSE = "kubernetes_tpu/ops/pallas_solver.py:754"
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, f32 operations/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
RACK = "example.com/rack"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# seeded problems
def _term(key, value, topo):
    return {"labelSelector": {"matchExpressions": [
        {"key": key, "operator": "In", "values": [value]}]},
        "topologyKey": topo}


def make_nodes(rng, n):
    nodes = []
    for i in range(n):
        labels = {HOST: f"node-{i}", RACK: f"r{i % 20}",
                  "pool": f"p{i % 4}"}
        if i != n - 1:
            labels[ZONE] = f"z{i % 10}"
        d = {"metadata": {"name": f"node-{i}", "labels": labels},
             "spec": {"unschedulable": i % 97 == 13, "taints": []},
             "status": {"capacity": {
                 "cpu": str(rng.choice([4, 8, 16, 32])),
                 "memory": str(rng.choice(["8Gi", "16Gi", "32Gi", "64Gi"])),
                 "pods": "110"}}}
        if i % 50 == 7:
            d["spec"]["taints"] = [{"key": "dedicated", "value": "infra",
                                    "effect": "NoSchedule"}]
        if i % 3 == 0:
            d["status"]["images"] = [{"names": [f"img/{i % 16}"],
                                      "sizeBytes": int(rng.integers(1, 3))
                                      << 30}]
        nodes.append(d)
    return nodes


def make_pods(rng, n, groups, profiles, prefix="p"):
    """Hard and soft spread per group, required affinity per group (its
    first pod matches nothing yet), anti-affinity per color, preferred
    (anti-)affinity weights, ``profiles`` distinct static profiles."""
    pods = []
    for i in range(n):
        g = int(rng.integers(groups))
        kind = int(rng.integers(5))
        requests = {"cpu": str(rng.choice(["100m", "250m", "500m", "1"])),
                    "memory": str(rng.choice(["128Mi", "256Mi", "1Gi"]))}
        spec = {"containers": [{"name": "c", "image": f"img/{i % profiles}",
                                "resources": {"requests": requests}}]}
        if i % profiles == 1:
            spec["nodeSelector"] = {"pool": "p1"}
        if i % profiles == 2:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if kind == 0:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1 + g % 3, "topologyKey": ZONE,
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"grp": f"g{g}"}}}]
        elif kind == 1:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1, "topologyKey": RACK,
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"grp": f"g{g}"}}}]
        elif kind == 2:
            spec["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term("grp", f"g{g}", ZONE)]}}
        elif kind == 3:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term("color", f"c{g}", HOST)]}}
        else:
            spec["affinity"] = {
                "podAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {"weight": 1 + g % 7,
                         "podAffinityTerm": _term("grp", f"g{g}", ZONE)}]},
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {"weight": 2, "podAffinityTerm":
                         _term("color", f"c{(g + 1) % groups}", HOST)}]}}
        pods.append({"metadata": {"name": f"{prefix}{i}", "labels": {
            "grp": f"g{g}", "color": f"c{g}"}}, "spec": spec})
    return pods


def encode(node_dicts, pod_dicts, pad):
    enc = BatchEncoder(new_snapshot([], [Node.from_dict(d)
                                         for d in node_dicts]))
    cluster, batch = enc.encode([Pod.from_dict(d) for d in pod_dicts],
                                pad_pods=pad)
    return cluster, batch


def on(device, ps: PStatic, state, ints, floats):
    moved = PStatic(ps.ints.to(device), ps.f32s.to(device),
                    ps.sc_meta.to(device), *ps[3:])
    return (moved, state.to(device).clone(),
            torch.as_tensor(ints).to(device), torch.as_tensor(floats).to(device))


def _solve_on_card(ps, state, ints, floats, plan=None):
    """One kernel launch on copies of the inputs on the card: the kernel
    the wrapper plans, or ``plan``'s (a slot plan takes a slot stream).
    Returns (assignments, final state, the kernel that ran)."""
    kernel = solve_mod.solve_kernel
    a = on("cuda", ps, state, ints, floats)
    before = dict(kernel.counts)
    if plan is None:
        got = kernel(PARAMS, *a)
    else:
        kernel.check(*a, slots=plan.kernel == "slots")
        got = kernel.launch(PARAMS, *a, plan)
    torch.cuda.synchronize()
    ran = [k for k in kernel.counts if kernel.counts[k] != before[k]]
    check(len(ran) == 1, "one kernel launch")
    return got, a[1], ran[0]


def compare_kernel_plain(name, ps, state, ints, floats, plan=None):
    """The planned kernel (or ``plan``'s), the one-block kernel and the
    plain version on the card, on the same inputs (the state planes
    copied for each). Returns ({kernel: largest absolute difference over
    assignments and final planes}, the planned kernel's final state)."""
    b = on("cuda", ps, state, ints, floats)
    want = solve_mod.solve_plain(PARAMS, *b)
    torch.cuda.synchronize()
    errs, final = {}, None
    n = ps.ints.shape[1]
    runs = [plan, solve_mod.block_plan(n, ps.sc, ps.t)]
    for i, p in enumerate(runs):
        got, st, ran = _solve_on_card(ps, state, ints, floats, p)
        err = max(int((got - want).abs().max()), int((st - b[1]).abs().max()))
        errs[ran] = max(errs.get(ran, 0), err)
        final = st if i == 0 else final
        check(err == 0, f"{ran} kernel equals plain on {name}")
    planned = plan or solve_mod.solve_kernel.plan(ps)
    log(f"  {name}: N={n} B={ints.shape[0]} SC={ps.sc} T={ps.t} U={ps.u} "
        f"SV={ps.sv} placed={int((want >= 0).sum())} "
        f"kernel={planned.kernel} "
        f"cluster={planned.cluster}x{planned.cols_per_block} cols "
        f"max_abs_err " + " ".join(f"{k}={v}" for k, v in errs.items()))
    return errs, final


def dense_from_slots(ps: PStatic, ints, floats):
    """The dense pod stream a slot stream was packed from (the pack loses
    nothing when it succeeds): base | match_by[T] | own_aff[T] |
    own_anti[T], and the weights [B, T]. Arrays on the CPU."""
    rows, w = np.asarray(ints.cpu()), np.asarray(floats.cpu())
    b, t, c = rows.shape[0], ps.t, ps.r + 4 + 2 * ps.sc
    idx, fl = rows[:, c:c + SPARSE_K], rows[:, c + SPARSE_K:]
    dense = np.zeros((b, c + 3 * t), dtype=np.int32)
    dense[:, :c] = rows[:, :c]
    dense_w = np.zeros((b, t), dtype=np.float32)
    pod = np.repeat(np.arange(b), SPARSE_K).reshape(b, SPARSE_K)
    active = (fl != 0) | (w != 0)
    for bit in range(3):
        on_bit = active & (((fl >> bit) & 1) > 0)
        dense[pod[on_bit], c + bit * t + idx[on_bit]] = 1
    dense_w[pod[active], idx[active]] = w[active]
    return torch.from_numpy(dense), torch.from_numpy(dense_w)


def _err(a, b, sa, sb):
    return max(int((a.cpu() - b.cpu()).abs().max()),
               int((sa.cpu() - sb.cpu()).abs().max()))


def compare_slots_plain(name, ps, state, ints, floats, plan=None):
    """The slot kernel (the wrapper's slot plan, or ``plan``) on the slot
    stream packed from the dense (ints, floats); the plain slot solve and
    the dense plain solve on the card; the one-block kernel on the dense
    stream. All must agree on assignments and final planes. Returns
    ({kernel: largest absolute difference}, the slot kernel's final
    state)."""
    kernel = solve_mod.solve_kernel
    stream = slot_stream(np.asarray(torch.as_tensor(ints)),
                         np.asarray(torch.as_tensor(floats)), ps.r, ps.sc,
                         ps.t)
    check(stream is not None, f"{name} packs into slots")
    sints, sfloats = (torch.from_numpy(a) for a in stream)
    b = on("cuda", ps, state, sints, sfloats)
    want = solve_mod.solve_plain_slots(PARAMS, *b)
    d = on("cuda", ps, state, ints, floats)
    dense = solve_mod.solve_plain(PARAMS, *d)
    torch.cuda.synchronize()
    check(_err(want, dense, b[1], d[1]) == 0,
          f"plain slot solve equals the dense plain solve on {name}")
    plan = plan or kernel.slots_plan(ps)
    got, st, ran = _solve_on_card(ps, state, sints, sfloats, plan)
    check(ran == "slots", f"{name} ran the slot kernel")
    errs = {ran: _err(got, want, st, b[1])}
    check(errs[ran] == 0, f"slot kernel equals plain on {name}")
    got_b, st_b, ran = _solve_on_card(ps, state, ints, floats,
                                      solve_mod.block_plan(
                                          ps.ints.shape[1], ps.sc, ps.t))
    errs[ran] = _err(got_b, want, st_b, b[1])
    check(errs[ran] == 0, f"one-block kernel equals plain on {name}")
    log(f"  {name}: N={ps.ints.shape[1]} B={sints.shape[0]} SC={ps.sc} "
        f"T={ps.t} U={ps.u} placed={int((want >= 0).sum())} slot kernel "
        f"cluster={plan.cluster}x{plan.cols_per_block} cols, "
        f"{plan.smem_bytes} B a block; max_abs_err "
        + " ".join(f"{k}={v}" for k, v in errs.items()))
    return errs, st


def slot_cases():
    """Seeded slot problems: (name, (planes, state, dense pod ints, pod
    floats), a forced slot plan or None)."""
    out = [("slots-anti-5120", random_slot_planes(20, 5120, 256, 100,
                                                  real=5000), None),
           ("slots-t50-5120", random_slot_planes(21, 5120, 128, 50, sc=2,
                                                 u=2), None),
           ("slots-ragged-1408", random_slot_planes(22, 1408, 96, 40, sc=2,
                                                    u=2, real=1400), None),
           ("slots-t16-1024", random_slot_planes(23, 1024, 64, 16, sc=3,
                                                 u=3, real=1000), None)]
    check(solve_mod.plan_launch(1024, 3, 3, 16, 3, packs=True).kernel
          == "cluster", "slots-t16-1024 is a shape the cluster kernel takes")
    out.append(("slots-portable-8", random_slot_planes(24, 5120, 96, 100,
                                                       sc=2, u=2),
                solve_mod.slots_candidate(5120, 3, 2, 100, 2,
                                          max_cluster=8)))
    return out


def phase_compare():
    errs = {"cluster": 0, "slots": 0, "block": 0}

    def keep(result):
        for k, v in result[0].items():
            errs[k] = max(errs[k], v)
        return result[1]

    rng = np.random.default_rng(0)
    cases = [("mixed-64", 64, 96, 4, 3), ("groups-64", 64, 96, 6, 5),
             ("wide-128", 128, 120, 12, 9)]
    for name, n, b, groups, profiles in cases:
        cluster, batch = encode(make_nodes(rng, n),
                                make_pods(rng, b, groups, profiles), 128)
        ps, state = prepare(cluster, batch, "cpu")
        ints, floats = pack_podin(batch)
        keep(compare_kernel_plain(name, ps, state, ints, floats))
        if name == "wide-128":
            check(ps.sc > 8 and ps.t > 8, "wide case is wider than eight")
    # identical nodes and pods: forced ties
    nodes = [workloads.node_template(i) for i in range(40)]
    cluster, batch = encode(nodes, [workloads.basic_pod(i)
                                    for i in range(300)], 304)
    ps, state = prepare(cluster, batch, "cpu")
    keep(compare_kernel_plain("ties-40", ps, state, *pack_podin(batch)))
    # two batches carrying the state: the second starts from the first's
    # final planes
    nodes = make_nodes(rng, 64)
    cluster, batch = encode(nodes, make_pods(rng, 64, 4, 3), 64)
    ps, state = prepare(cluster, batch, "cpu")
    ints, floats = pack_podin(batch)
    half = np.zeros_like(ints), np.zeros_like(floats)
    half[0][:32], half[1][:32] = ints[:32], floats[:32]
    carried = keep(compare_kernel_plain("carry-1", ps, state, *half))
    rest = np.zeros_like(ints), np.zeros_like(floats)
    rest[0][:32], rest[1][:32] = ints[32:], floats[32:]
    keep(compare_kernel_plain("carry-2", ps, carried.cpu(), *rest))
    # the headline width with a wide constraint space
    cluster, batch = encode(make_nodes(rng, 5000),
                            make_pods(rng, 512, 8, 16, prefix="h"), 512)
    ps, state = prepare(cluster, batch, "cpu")
    check(ps.ints.shape[1] == 5120, "headline width pads to 5120 columns")
    check(max(ps.sc, ps.t, ps.u) > 8, "headline case wider than eight")
    keep(compare_kernel_plain("headline-5120x512", ps, state,
                              *pack_podin(batch)))
    for name, args, plan, want in planes_cases():
        ran = (plan or solve_mod.solve_kernel.plan(args[0])).kernel
        check(ran == want, f"{name} plans the {want} kernel")
        keep(compare_kernel_plain(name, *args, plan=plan))
    for name, args, plan in slot_cases():
        keep(compare_slots_plain(name, *args, plan=plan))
    # two slot batches carrying the state
    ps, state, ints, floats = random_slot_planes(27, 5120, 128, 100, sc=2,
                                                 u=2)
    carried = keep(compare_slots_plain("slots-carry-1", ps, state,
                                       ints[:64], floats[:64]))
    keep(compare_slots_plain("slots-carry-2", ps, carried.cpu(),
                             ints[64:].clone(), floats[64:].clone()))
    # two shared-volume batches carrying the state (attached bits too)
    ps, state, ints, floats = random_planes(35, 2048, 256, r=4, sc=2, t=2,
                                            u=2, sv=32)
    carried = keep(compare_kernel_plain("sv-carry-1", ps, state, ints[:128],
                                        floats[:128]))
    keep(compare_kernel_plain("sv-carry-2", ps, carried.cpu(),
                              ints[128:].clone(), floats[128:].clone()))
    return errs


def planes_cases():
    """Seeded cases made in the planes layout: (name, (planes, state,
    pod ints, pod floats), a forced launch plan or None, the kernel that
    must run)."""
    out = [("ragged-1408", random_planes(3, 1408, 96, sc=2, t=2, u=2,
                                         real=1400), None, "cluster")]
    ps, state, ints, floats = random_planes(4, 5120, 40)
    so, _ = static_planes(ps.r, ps.sc, ps.t, ps.u)
    do, _ = state_planes(ps.r, ps.sc, ps.t)
    ps.ints[so["masks"]:so["masks"] + ps.u] = 0
    ps.ints[so["masks"]:so["masks"] + ps.u, 5100] = 1
    ps.ints[so["alloc"]:so["alloc"] + ps.r, 5100] = 10 ** 7
    ps.ints[so["max_pods"], 5100] = 1000
    state[do["requested"]:do["pod_count"] + 1, 5100] = 0
    ints[:, ps.r + 4:] = 0
    out.append(("only-last-slice", (ps, state, ints, floats), None,
                "cluster"))
    ps, state, ints, floats = random_planes(5, 5120, 64)
    for planes in (ps.ints, ps.f32s, state):
        planes[:] = planes[:, :1].clone()
    ps.ints[so["node_valid"], :330] = 0
    ints[:, ps.r + 4:] = 0
    floats[:] = 0
    out.append(("ties-across-slices", (ps, state, ints, floats), None,
                "cluster"))
    out.append(("wide16-5120", random_planes(6, 5120, 128, sc=16, t=16,
                                             u=16, real=5000), None,
                "cluster"))
    out.append(("portable-8", random_planes(9, 5120, 96, sc=2, t=2, u=2),
                solve_mod.plan_launch(5120, 3, 2, 2, 2, max_cluster=8),
                "cluster"))
    out.append(("past-budget", random_planes(8, 5120, 32, sc=40, t=40, u=2),
                None, "block"))
    # the shared-volume attach planes (the last resource an attach
    # column): both kernels carry them
    out += [
        ("sv8-1024", random_planes(30, 1024, 256, r=4, sc=2, t=2, u=2,
                                   real=1000, sv=8), None, "cluster"),
        ("sv64-5120", random_planes(31, 5120, 256, r=4, real=5000, sv=64),
         None, "cluster"),
        ("sv512-1024x1024", random_planes(32, 1024, 1024, r=4, real=1000,
                                          sv=512), None, "cluster"),
        ("sv16-portable-8", random_planes(33, 5120, 96, r=4, sc=2, t=2, u=2,
                                          sv=16),
         solve_mod.plan_launch(5120, 4, 2, 2, 2, max_cluster=8, sv=16),
         "cluster"),
        ("sv8-past-budget", random_planes(34, 5120, 32, r=4, sc=40, t=40,
                                          u=2, sv=8), None, "block")]
    # T = 100 with one pod of nine term references: the batch does not
    # pack, so the dense stream runs on the one-block kernel
    ps, state, ints, floats = random_slot_planes(25, 5120, 64, 100)
    ints[3, ps.r + 4 + 2 * ps.sc:ps.r + 4 + 2 * ps.sc + 9] = 1
    check(slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc, ps.t)
          is None, "the nine-reference batch does not pack")
    out.append(("nine-refs-t100", (ps, state, ints, floats), None, "block"))
    return out


# ----------------------------------------------------------------------
class _Recorder:
    """Stands in for the kernel wrapper during a run: CUDA events around
    each launch and, with ``keep``, copies of each launch's inputs, taken
    on the stream without waiting for it. The launch, and its count,
    stay the wrapper's."""

    def __init__(self, kernel, keep=False):
        self.kernel = kernel
        self.keep = keep
        self.events = []
        self.inputs = []
        self.slots = []     # per kept launch: a slot stream or not

    def __getattr__(self, name):   # plan, slots_plan: the wrapper's
        return getattr(self.kernel, name)

    def __call__(self, params, ps, state, ints, floats, **kw):
        if self.keep:
            self.inputs.append((ps, state.clone(), ints.clone(),
                                floats.clone()))
            self.slots.append(kw.get("slots", False))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.kernel(params, ps, state, ints, floats, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def kernel_ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def largest(self, slots=False):
        """The kept inputs of the launch with the most valid pods, among
        the slot-stream launches with ``slots``, else the dense ones."""
        kept = [i for i, s in zip(self.inputs, self.slots) if s == slots]
        valid = [int((i[2][:, i[0].r + 3] > 0).sum()) for i in kept]
        return kept[int(np.argmax(valid))]


class _Dispatches:
    """While entered: every ``CudaPlanesBackend.solve_lazy`` call's host
    wall time and the cyclic GC's pauses inside it, the waits its
    staging ring made for a buffer still in use, whether its event still
    reported the card busy right after it returned, and whether it ran
    inside a warmup."""

    def __init__(self):
        self.calls = []
        self._warming = False
        self._gc_s = 0.0
        self._gc_t0 = 0.0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self._gc_s += time.perf_counter() - self._gc_t0

    def __enter__(self):
        self._solve = CudaPlanesBackend.solve_lazy
        self._warmup = BatchScheduler.warmup
        real_solve, real_warmup = self._solve, self._warmup

        def solve_lazy(backend, *args):
            waits = backend.staging.waits
            gc_s = self._gc_s
            t0 = time.perf_counter()
            handle = real_solve(backend, *args)
            wall = (time.perf_counter() - t0) * 1000
            busy = handle.event is not None and not handle.event.query()
            self.calls.append({
                "wall_ms": wall, "gc_ms": (self._gc_s - gc_s) * 1000,
                "busy": busy, "warming": self._warming,
                "ring_waits": backend.staging.waits - waits})
            return handle

        def warmup(bs, pods):
            self._warming = True
            try:
                return real_warmup(bs, pods)
            finally:
                self._warming = False

        CudaPlanesBackend.solve_lazy = solve_lazy
        BatchScheduler.warmup = warmup
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        CudaPlanesBackend.solve_lazy = self._solve
        BatchScheduler.warmup = self._warmup
        gc.callbacks.remove(self._on_gc)


LAUNCHES = {"cluster": 0, "slots": 0, "block": 0}   # main-path launches


def run_path(name, run, keep=False, kernel="cluster", cold=False):
    """``run()`` on the card with the kernels' launch counts reset just
    before and read just after, the plain version trapped, each launch
    timed with CUDA events and each dispatch with the host clock. Every
    launch must be ``kernel``'s (None: the caller checks the launch plan
    of each). With ``cold`` (a row whose every cycle follows its warm-up)
    no kernel instance counts as launched and the pinned staging ring is
    empty: the warm-up must book each first launch and allocation, or a
    measured cycle does, and ``row_report`` fails it. Returns (run's result, counts, kernel ms per launch,
    dispatches, the recorder, wall seconds)."""
    plain_calls = []
    real_plain, real_kernel = solve_mod.solve_plain, solve_mod.solve_kernel
    recorder = _Recorder(real_kernel, keep)

    def trapped_plain(*args):
        plain_calls.append(1)
        return real_plain(*args)

    solve_mod.solve_plain, solve_mod.solve_kernel = trapped_plain, recorder
    real_kernel.reset_counts()
    if cold:
        real_kernel.launched.clear()
        solve_mod.STAGING.clear()
    try:
        with _Dispatches() as dispatches:
            t0 = time.monotonic()
            out = run()
            wall = time.monotonic() - t0
    finally:
        counts = dict(real_kernel.counts)
        solve_mod.solve_plain, solve_mod.solve_kernel = real_plain, real_kernel
    for k in LAUNCHES:
        LAUNCHES[k] += counts[k]
    kernel_ms = recorder.kernel_ms()
    if kernel is not None:
        check(counts[kernel] > 0, f"{name}: the {kernel} kernel launched")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{name}: other kernels launched: {others}")
    check(not plain_calls, f"{name}: plain version called on the card")
    check(len(kernel_ms) == sum(counts.values()) == len(dispatches.calls),
          f"{name}: one timed launch and one dispatch per launch")
    return out, counts, kernel_ms, dispatches.calls, recorder, wall


def run_main_path(name, nodes, pods, max_batch=4096):
    """One workload on the card through run_workload (default arms:
    pipelined, mirror on), cold (``run_path``). Every pod bound, the
    cluster kernel launched once per solve."""
    res, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: perf.run_workload(
            name, workloads.make_workload(name, nodes, 0, pods),
            max_batch=max_batch, device="cuda"), keep=True, cold=True)
    launches = counts["cluster"]
    check(res.device.startswith("cuda"), f"{name} ran on the card")
    check(len(res.placements) == pods, f"{name} created {pods} pods")
    unbound = sum(1 for v in res.placements.values() if not v)
    check(unbound == 0, f"{name}: {unbound} pods left unbound")
    check(launches == res.solves, f"{name}: cluster kernel launches "
          f"{launches} == solves {res.solves}")
    busy = sum(kernel_ms) / 1000
    log(f"  {name} {nodes} nodes / {pods} pods on {res.device}: "
        f"{res.pods_per_second:.1f} pods/s over {res.duration_seconds:.3f} s "
        f"(whole run {wall:.1f} s)")
    log(f"    enqueue->bind ms p50/p90/p99: "
        + "/".join(f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90",
                                                      "Perc99"))
        + "; solve-start->bind ms p50/p90/p99: "
        + "/".join(f"{res.metrics[k]:.1f}" for k in ("Perc50", "Perc90",
                                                      "Perc99")))
    log(f"    solves={res.solves} rebuilds={res.rebuilds} launches "
        f"cluster={launches} block={counts['block']} kernel ms/launch "
        f"(wrapper call) mean={np.mean(kernel_ms):.3f} "
        f"max={np.max(kernel_ms):.3f} kernel busy {busy:.3f} s")
    log("    host seconds: " + ", ".join(
        f"{k}={v:.3f}" for k, v in res.seconds.items()))
    return res, counts, kernel_ms, recorder.largest()


def zone_skew(res):
    per_zone = {}
    for node in res.placements.values():
        z = int(node.split("-")[1]) % 10
        per_zone[z] = per_zone.get(z, 0) + 1
    return max(per_zone.values()) - min(per_zone.values())


def phase_small_slices():
    for name, nodes, pods in (("SchedulingBasic", 200, 1000),
                              ("TopologySpreading", 200, 600)):
        ops = workloads.make_workload(name, nodes, 0, pods)
        card = perf.run_workload(name, ops, max_batch=128, device="cuda")
        ops = workloads.make_workload(name, nodes, 0, pods)
        cpu = perf.run_workload(name, ops, max_batch=128, device="cpu")
        check(all(card.placements.values()), f"{name} small: all bound")
        check(card.placements == cpu.placements,
              f"{name} small: card and CPU place every pod alike")
        log(f"  {name} {nodes}/{pods}: card == CPU on {pods} placements")


def bound_ms(ps: PStatic, state, ints, floats):
    """Least time for one launch on these inputs: bytes (each input read
    once, each output written once) over HBM bandwidth, and the
    operations these pods need (counted per valid pod x node from their
    flags) over the f32 peak; the larger of the two. Shared-volume rows
    no valid pod references are neither read nor written."""
    n = ps.ints.shape[1]
    rows = ints.cpu().numpy()
    w = floats.cpu().numpy()
    c, t = ps.r + 4 + 2 * ps.sc, ps.t
    flags = rows[:, c:c + 3 * t] > 0
    slotted = np.zeros(rows.shape[0], dtype=bool)
    unused_sv = 0
    if ps.sv:
        slot = rows[:, c + 3 * t]
        slotted = (slot < ps.sv) & (rows[:, ps.r + 3] > 0)
        unused_sv = ps.sv - len(np.unique(slot[slotted]))
    nbytes = sum(t.numel() * t.element_size() for t in (
        ps.ints, ps.f32s, ps.sc_meta, ints, floats)) \
        + 2 * (state.numel() - unused_sv * n) * state.element_size() \
        + ints.shape[0] * 4
    return _bound(ps, nbytes, rows, (w != 0).sum(1), flags.sum(1),
                  flags[:, :t].sum(1), slotted)


def bound_ms_slots(ps: PStatic, state, ints, floats):
    """``bound_ms`` for a slot stream, counting what these slots need: the
    term rows no valid pod references are neither read nor written."""
    n = ps.ints.shape[1]
    rows = ints.cpu().numpy()
    w = floats.cpu().numpy()
    c = ps.r + 4 + 2 * ps.sc
    idx, fl = rows[:, c:c + SPARSE_K], rows[:, c + SPARSE_K:]
    active = ((fl != 0) | (w != 0)) & (rows[:, ps.r + 3:ps.r + 4] > 0)
    unused = ps.t - len(np.unique(idx[active]))
    nbytes = sum(t.numel() * t.element_size() for t in (
        ps.ints, ps.f32s, ps.sc_meta, ints, floats)) - unused * n * 4 \
        + 2 * (state.numel() - 2 * unused * n) * state.element_size() \
        + ints.shape[0] * 4
    bits = [(fl >> bit) & 1 for bit in range(3)]
    return _bound(ps, nbytes, rows, (w != 0).sum(1),
                  sum(b.sum(1) for b in bits), bits[0].sum(1))


def _bound(ps: PStatic, nbytes, rows, weights, flags, matched,
           slotted=0):
    """The larger of ``nbytes`` over HBM bandwidth and the pods'
    operations over the f32 peak, from each pod's counts of preferred
    weights, term flags and matched terms, and whether it references a
    shared-volume slot."""
    n = ps.ints.shape[1]
    r, sc = ps.r, ps.sc
    hard = ps.sc_meta[1].cpu().numpy() > 0
    valid = rows[:, r + 3] > 0
    pod_sc = rows[:, r + 4:r + 4 + sc] > 0
    sc_match = rows[:, r + 4 + sc:r + 4 + 2 * sc] != 0
    per_pod = (
        3 + r                      # validity, pod count, mask, fit
        + 27                       # balanced, least, score sum, argmax
        + 5 * (pod_sc & hard).sum(1)         # domain min, skew check
        + 2 * (pod_sc & ~hard).sum(1)        # soft counts
        + 2 * (pod_sc & ~hard).any(1)        # spread score
        + 3 * weights                        # preferred weights
        + 2 * flags                          # (anti-)affinity checks
        + 2 * sc_match.sum(1)                # domain commits
        + 3 * matched                        # term commits
        + 4 * slotted                        # attach demand and fit
    )
    ops = float((per_pod * valid).sum()) * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1000
    t_ops = ops / PEAK_F32_OPS_PER_S * 1000
    log(f"  bound inputs: {nbytes} bytes -> {t_bytes:.6f} ms, {ops:.0f} "
        f"operations -> {t_ops:.6f} ms")
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def cut_columns(batch, n):
    """A batch on the first ``n`` node columns of its planes."""
    ps, state, ints, floats = batch
    cut = PStatic(ps.ints[:, :n].contiguous(), ps.f32s[:, :n].contiguous(),
                  ps.sc_meta, *ps[3:])
    return cut, state[:, :n].contiguous(), ints, floats


def _event_ms(fn, state, repeats):
    """Mean ms of ``repeats`` calls of ``fn(fresh state copy)``, CUDA
    events around each call only."""
    times = []
    for _ in range(repeats):
        st = state.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(st)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def time_batch(name, batch, repeats=10):
    """Both kernels on one batch, in turns (one-block, cluster, cluster,
    one-block), each a mean over ``repeats`` bare launches after one
    warm-up, with the wrapper's whole call (input checks included) timed
    beside them. The two kernels must agree on the batch. Returns the
    timings and the cluster kernel's (assignments, final state)."""
    kernel = solve_mod.solve_kernel
    ps, state, ints, floats = batch
    kernel.check(ps, state, ints, floats)
    plans = {"cluster": kernel.plan(ps),
             "block": solve_mod.block_plan(ps.ints.shape[1], ps.sc, ps.t)}
    check(plans["cluster"].kernel == "cluster",
          f"{name} plans the cluster kernel")
    turns, finals = {}, {}
    for which in ("block", "cluster", "cluster", "block"):
        plan = plans[which]

        def bare(st, plan=plan):
            finals[plan.kernel] = (kernel.launch(PARAMS, ps, st, ints,
                                                 floats, plan), st)

        _event_ms(bare, state, 1)
        turns.setdefault(which, []).append(_event_ms(bare, state, repeats))
    (a, sa), (b, sb) = finals["cluster"], finals["block"]
    err = max(int((a - b).abs().max()), int((sa - sb).abs().max()))
    check(err == 0, f"{name}: cluster kernel equals one-block kernel")
    whole = _event_ms(lambda st: kernel(PARAMS, ps, st, ints, floats), state,
                      repeats)
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    valid = int((ints[:, ps.r + 3] > 0).sum())
    p = plans["cluster"]
    log(f"  {name}: N={ps.ints.shape[1]} B={ints.shape[0]} valid={valid}; "
        f"cluster of {p.cluster} x {p.cols_per_block} columns, {p.threads} "
        f"threads, {p.smem_bytes} B shared a block")
    log(f"    one-block ms {turns['block'][0]:.3f} / {turns['block'][1]:.3f};"
        f" cluster ms {turns['cluster'][0]:.3f} / {turns['cluster'][1]:.3f};"
        f" per pod cluster {ms['cluster'] / valid * 1000:.3f} us, one-block "
        f"{ms['block'] / valid * 1000:.3f} us; wrapper call (cluster, checks "
        f"included) {whole:.3f} ms")
    return {"n": ps.ints.shape[1], "valid_pods": valid, "ms": ms,
            "turns": turns, "wrapper_ms": whole, "err": err,
            "plan": p._asdict()}, finals["cluster"]


def cluster_sweep(name, batch, repeats=10):
    """The cluster kernel on one batch at cluster sizes 16, 8, 4 and 2
    (each plan the size rule keeps on the cluster kernel): ms per launch,
    a mean over ``repeats`` bare launches after one warm-up. Every size
    must give the same assignments and planes."""
    kernel = solve_mod.solve_kernel
    ps, state, ints, floats = batch
    kernel.check(ps, state, ints, floats)
    out, first = {}, None
    for size in (16, 8, 4, 2):
        plan = solve_mod.plan_launch(ps.ints.shape[1], ps.r, ps.sc, ps.t,
                                     ps.u, max_cluster=size)
        if plan.kernel != "cluster":
            continue
        got = {}

        def bare(st, plan=plan):
            got["a"] = (kernel.launch(PARAMS, ps, st, ints, floats, plan), st)

        _event_ms(bare, state, 1)
        out[plan.cluster] = _event_ms(bare, state, repeats)
        a, st = got["a"]
        first = first or (a, st)
        check(bool((a == first[0]).all()) and bool((st == first[1]).all()),
              f"{name}: cluster of {plan.cluster} equals the others")
    log(f"  {name}, cluster kernel ms by cluster size: " + ", ".join(
        f"{k}: {v:.3f}" for k, v in out.items()))
    return out


def plain_against(name, batch, got, kernel="cluster"):
    """One run of the plain version on the card (host clock) against the
    kernel's (assignments, final state) on the same batch. Returns (ms,
    largest absolute difference), which must be 0."""
    ps, state, ints, floats = batch
    st = state.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = solve_mod.solve_plain(PARAMS, ps, st, ints, floats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000
    err = max(int((got[0] - want).abs().max()),
              int((got[1] - st).abs().max()))
    check(err == 0, f"{kernel} kernel equals plain on the {name} batch")
    log(f"  plain version on the {name} batch {ms:.1f} ms, max_abs_err "
        f"{err}")
    return ms, err


def split_per_pod(big, small):
    """Per-pod time as a fixed cost plus a cost per column, from the same
    pods on two plane widths: (fixed us, per-column ns) per kernel."""
    out = {}
    for k in big["ms"]:
        per_col = ((big["ms"][k] - small["ms"][k]) / (big["n"] - small["n"])
                   / big["valid_pods"] * 1e6)
        fixed = big["ms"][k] / big["valid_pods"] * 1000 \
            - per_col * big["n"] / 1000
        out[k] = (fixed, per_col)
        log(f"  {k} kernel per pod: {fixed:.3f} us fixed + {per_col:.4f} ns "
            f"per column (N={small['n']} and N={big['n']})")
    return out


def print_ptxas(lib):
    """ptxas's registers, shared memory and spills of each kernel."""
    report = solve_mod.ptxas_report_path(lib).read_text().splitlines()
    for i, line in enumerate(report):
        if "Compiling entry function" in line:
            log(f"  {line.strip()}")
            for follow in report[i + 1:i + 4]:
                if "ptxas info" in follow or "bytes stack frame" in follow:
                    log(f"    {follow.strip()}")


# ----------------------------------------------------------------------
def _ms_list(xs):
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def phase_pipeline(nodes=5000, pods=30000, max_batch=4096):
    """SchedulingBasic in turns: serialized, pipelined, pipelined,
    serialized. Every run binds every pod, to the same nodes; every
    dispatch returns in under half its kernel's time, and some return
    while their kernel still runs."""
    runs = []
    for pipeline in (False, True, True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"SchedulingBasic {arm}"
        res, counts, kernel_ms, calls, _, wall = run_path(
            name, lambda: perf.run_workload(
                "SchedulingBasic",
                workloads.make_workload("SchedulingBasic", nodes, 0, pods),
                max_batch=max_batch, device="cuda", pipeline=pipeline),
            cold=True)
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(len(res.placements) == pods and all(res.placements.values()),
              f"{name}: every pod bound")
        check(counts["cluster"] == res.solves,
              f"{name}: one cluster launch per solve")
        measured = [(c, k) for c, k in zip(calls, kernel_ms)
                    if not c["warming"]]
        # the cyclic GC's pauses are host time, not a wait for the card
        slow = [(round(c["wall_ms"], 3), round(c["gc_ms"], 3), round(k, 3))
                for c, k in measured if c["wall_ms"] - c["gc_ms"] > 0.5 * k]
        check(not slow, f"{name}: dispatches over half their kernel's time "
              f"(a hidden wait for the card; wall ms, GC ms, kernel ms): "
              f"{slow}")
        waits = sum(c["ring_waits"] for c, _ in measured)
        check(waits == 0, f"{name}: {waits} staging buffers still in use")
        check(any(c["busy"] for c, _ in measured),
              f"{name}: every dispatch returned after its kernel ended")
        depth = (res.pipeline_info or {}).get("depth", 0)
        log(f"  {name}: {res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"enqueue->bind p99 {res.latency['Perc99']:.1f} ms; solves "
            f"{res.solves} rebuilds {res.rebuilds} carry_chained "
            f"{res.carry_chained} pipeline depth {depth}")
        log(f"    dispatch ms {_ms_list(c['wall_ms'] for c, _ in measured)}"
            f" (GC in them {_ms_list(c['gc_ms'] for c, _ in measured)}) "
            f"against kernel ms {_ms_list(k for _, k in measured)}; busy "
            f"after dispatch {[c['busy'] for c, _ in measured]}")
        log("    host s from dispatch to materialize "
            f"{_ms_list(h[0] for h in res.handoffs)}, waited "
            f"{_ms_list(h[1] for h in res.handoffs)}")
        log("    host seconds: " + ", ".join(
            f"{k}={v:.3f}" for k, v in res.seconds.items()))
        runs.append({
            "arm": arm, "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency,
            "solve_to_bind_ms": res.metrics, "solves": res.solves,
            "rebuilds": res.rebuilds, "carry_chained": res.carry_chained,
            "pipeline_depth_max": depth, "handoffs_s": res.handoffs,
            "dispatch_ms": [c["wall_ms"] for c, _ in measured],
            "dispatch_gc_ms": [c["gc_ms"] for c, _ in measured],
            "kernel_ms": [k for _, k in measured],
            "busy_after_dispatch": [c["busy"] for c, _ in measured],
            "host_seconds": res.seconds, "placements": res.placements})
    first = runs[0].pop("placements")
    for r in runs[1:]:
        check(r.pop("placements") == first,
              f"{r['arm']} run binds like the first serialized run")
    log(f"  all four runs bound the same {len(first)} pods to the same "
        "nodes")
    return runs


def scatter_bound_ms(kind, entries):
    """The least time of one scatter of ``entries`` (row, column, value)
    int32 triples: the triples read once, each target cell read and
    written once (an add) or written once (a set), over the card's
    memory rate."""
    nbytes = entries * (12 + (8 if kind == "add" else 4))
    return nbytes / PEAK_BYTES_PER_S * 1e3


class _ScatterTimer:
    """While entered: CUDA events around each of the backend's scatters
    and each one's bound (``scatter_bound_ms``); ``ms()`` their device
    times."""

    def __enter__(self):
        self.events = {"add": [], "set": []}
        self.bounds = {"add": [], "set": []}
        self._real = {"add": CudaPlanesBackend.scatter_state_add,
                      "set": CudaPlanesBackend.scatter_static_set}

        def timed(kind):
            real = self._real[kind]

            def scatter(backend, planes, *entries):
                self.bounds[kind].append(
                    scatter_bound_ms(kind, len(entries[0])))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = real(backend, planes, *entries)
                end.record()
                self.events[kind].append((start, end))
                return out
            return scatter

        CudaPlanesBackend.scatter_state_add = timed("add")
        CudaPlanesBackend.scatter_static_set = timed("set")
        return self

    def __exit__(self, *exc):
        CudaPlanesBackend.scatter_state_add = self._real["add"]
        CudaPlanesBackend.scatter_static_set = self._real["set"]

    def ms(self):
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


def phase_churn(nodes=5000, waves=6, per_wave=5000, max_batch=4096):
    """The churn path (``workloads.churn``: bulk pod deletes and
    allocatable-only node updates after each wave, a pod deleted while a
    batch is held) with the mirror on and off: the same pods bound to
    the same nodes, none lost; the mirror-on run catches up, and after
    every catch-up its planes equal a fresh prepare from the cache."""
    sample = [Pod.from_dict(workloads.basic_pod(0))]
    real_catch_up = mirror_mod.DeviceClusterMirror.catch_up
    compared = []

    def catch_up(mirror, lo, hi):
        out = real_catch_up(mirror, lo, hi)
        if out is not None:
            sess = mirror._session
            ps, state = sess.fresh_planes(sample, 8)
            same = (torch.equal(sess._state, state)
                    and torch.equal(sess._static.ints, ps.ints)
                    and torch.equal(sess._static.f32s, ps.f32s))
            check(same, "planes after a catch-up equal a fresh prepare")
            compared.append(hi - lo)
        return out

    runs = {}
    mirror_mod.DeviceClusterMirror.catch_up = catch_up
    try:
        for mirror in (True, False):
            arm = "on" if mirror else "off"
            name = f"churn mirror {arm}"
            with _ScatterTimer() as timer:
                res, counts, kernel_ms, _, _, wall = run_path(
                    name, lambda: perf.run_workload(
                        "churn", workloads.churn(nodes, waves, per_wave,
                                                 seed=9),
                        max_batch=max_batch, device="cuda", mirror=mirror))
            scatter_ms = timer.ms()
            scatter_bounds = timer.bounds
            left = res.total_pods - res.deleted_pods
            check(len(res.placements) == left
                  and all(res.placements.values()),
                  f"{name}: every pod not deleted is bound ({left})")
            check(counts["cluster"] == res.solves,
                  f"{name}: one cluster launch per solve")
            check(res.pipeline_info["discards"] >= 1,
                  f"{name}: the held batch was discarded")
            info = res.mirror_info or {}
            if mirror:
                check(info["catch_ups"] > 0 and info["events"] > 0,
                      f"{name}: catch-ups scattered the churn")
                check(len(compared) == info["catch_ups"],
                      f"{name}: every catch-up compared")
            log(f"  {name}: {res.pods_per_second:.1f} pods/s over "
                f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
                f"{res.total_pods} created, {res.deleted_pods} deleted; "
                f"solves {res.solves} rebuilds {res.rebuilds} "
                f"discards {res.pipeline_info['discards']}")
            log(f"    mirror {info}; scatters {res.scatters}; scatter host "
                f"s {res.seconds['scatter']:.4f}; scatter device ms add "
                f"{_ms_list(scatter_ms['add'])} set "
                f"{_ms_list(scatter_ms['set'])}; bound ms add "
                f"{[f'{x:.6f}' for x in scatter_bounds['add']]} set "
                f"{[f'{x:.6f}' for x in scatter_bounds['set']]}")
            runs[arm] = {
                "pods_per_s": res.pods_per_second,
                "duration_s": res.duration_seconds, "wall_s": wall,
                "created": res.total_pods, "deleted": res.deleted_pods,
                "solves": res.solves, "rebuilds": res.rebuilds,
                "mirror": res.mirror_info, "pipeline": res.pipeline_info,
                "scatters": res.scatters, "scatter_device_ms": scatter_ms,
                "scatter_bound_ms": scatter_bounds,
                "host_seconds": res.seconds,
                "enqueue_to_bind_ms": res.latency,
                "kernel_ms": kernel_ms, "placements": res.placements}
    finally:
        mirror_mod.DeviceClusterMirror.catch_up = real_catch_up
    check(runs["on"].pop("placements") == runs["off"].pop("placements"),
          "churn: mirror on and off bind the same pods to the same nodes")
    log(f"  mirror on == off; {len(compared)} catch-ups (windows of "
        f"{compared} mutations) equal a fresh prepare")
    return runs


def phase_sustained(pods=30000, qps=5000.0, seed=14, max_batch=4096):
    """The sustained-arrival row, pipelined and serialized: no pod lost,
    every arrival injected."""
    rows = {}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"sustained {arm}"
        row, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: sustained.run_sustained_row(
                pods=pods, qps=qps, seed=seed, node_cpu=32,
                max_batch=max_batch, device="cuda", pipeline=pipeline))
        check(row["device"].startswith("cuda"), f"{name} ran on the card")
        check(row["lost_pods"] == 0 and row["injected"] == row["expected"]
              == pods and not row["send_errors"],
              f"{name}: {row['lost_pods']} lost, {row['injected']} of "
              f"{row['expected']} injected")
        check(counts["cluster"] == row["session"]["solves"],
              f"{name}: one cluster launch per solve")
        depth = (row["pipeline"] or {}).get("depth", 0)
        log(f"  {name}: {row['metric']}: arrival->bind p50 "
            f"{row['p50_arrival_to_bind_ms']:.1f} ms p99 "
            f"{row['p99_arrival_to_bind_ms']:.1f} ms; {row['value']:.1f} "
            f"pods/s, rate-normalized {row['rate_normalized_throughput']:.4f}"
            f"; pipeline depth {depth}; solves {row['session']['solves']} "
            f"carry_chained {row['session']['carry_chained']}; kernel busy "
            f"{sum(kernel_ms) / 1000:.3f} s of {row['wall_s']:.3f} s")
        session = row["session"]
        log(f"    rebuilds {session['rebuilds']} incremental "
            f"{session['incremental_hits']}; host seconds " + ", ".join(
                f"{k}={v:.3f}" for k, v in session["seconds"].items()))
        row["kernel_ms"] = kernel_ms
        rows[arm] = row
    return rows


def _host_split(res):
    """The host seconds of the paths behind the solve, and the batch
    path's own."""
    return (", ".join(f"{k}={v:.3f}" for k, v in res.host_paths.items())
            + "; " + ", ".join(f"{k}={v:.3f}" for k, v in res.seconds.items()))


def check_preemption_row(name, res, nodes):
    """Every measured pod bound, exactly one priority-1 pod deleted per
    measured pod, every other pod still there and bound, one pod a node.
    Returns (pod -> node map, victim names)."""
    init = {f"pod-{i}" for i in range(nodes)}
    measured = {f"pod-{nodes + i}" for i in range(nodes)}
    unbound = sorted(n for n in measured if not res.placements.get(n))
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound "
          f"({unbound[:5]})")
    victims = init - set(res.placements)
    check(len(victims) == nodes == res.victims,
          f"{name}: {len(victims)} priority-1 pods deleted ({res.victims} "
          f"gone in all) for {nodes} measured pods")
    check(set(res.placements) == measured | (init - victims)
          and all(res.placements.values()),
          f"{name}: every pod left is bound and none is lost")
    per_node = {}
    for node in res.placements.values():
        per_node[node] = per_node.get(node, 0) + 1
    check(len(per_node) == nodes and max(per_node.values()) == 1,
          f"{name}: one pod a node")
    return res.placements, victims


def phase_preemption(nodes=5000, seed=11, max_batch=4096):
    """The Preemption row in the default arms (pipelined, mirror on) and
    serialized: checked, and both arms bind alike and evict alike."""
    runs = {}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"Preemption {arm}"
        res, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: perf.run_workload(
                "Preemption", workloads.preemption(nodes, nodes, nodes),
                max_batch=max_batch, device="cuda", pipeline=pipeline,
                seed=seed))
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(counts["cluster"] == res.solves,
              f"{name}: cluster kernel launches {counts['cluster']} == "
              f"solves {res.solves}")
        placements, victims = check_preemption_row(name, res, nodes)
        log(f"  {name} {nodes} nodes / {nodes} / {nodes} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"{len(victims)} victims, PostFilter runs "
            f"{res.post_filter_runs}; solves {res.solves} rebuilds "
            f"{res.rebuilds}; kernel busy {sum(kernel_ms) / 1000:.3f} s")
        log(f"    host seconds: {_host_split(res)}")
        runs[arm] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "victims": len(victims), "solves": res.solves,
            "rebuilds": res.rebuilds, "launches": counts,
            "post_filter_runs": res.post_filter_runs,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds,
            "enqueue_to_bind_ms": res.latency, "kernel_ms": kernel_ms,
            "placements": placements, "victim_set": victims}
    piped, serial = runs["pipelined"], runs["serialized"]
    check(piped.pop("placements") == serial.pop("placements"),
          "Preemption: both arms bind the same pods to the same nodes")
    check(piped.pop("victim_set") == serial.pop("victim_set"),
          "Preemption: both arms evict the same pods")
    log("  pipelined == serialized: bound set and victim set")
    return runs


def phase_unschedulable(nodes=5000, impossible=1000, pods=10000,
                        max_batch=4096):
    """The Unschedulable row: the measured pods bound around pods no node
    can take, which carry the FitError status of the static masks and
    never ran PostFilter."""
    name = "Unschedulable"
    res, counts, kernel_ms, _, _, wall = run_path(
        name, lambda: perf.run_workload(
            name, workloads.unschedulable(nodes, impossible, pods),
            max_batch=max_batch, device="cuda"))
    check(counts["cluster"] == res.solves,
          f"{name}: cluster kernel launches {counts['cluster']} == solves "
          f"{res.solves}")
    unbound = [f"pod-{impossible + i}" for i in range(pods)
               if not res.placements.get(f"pod-{impossible + i}")]
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
    msg = (f"0/{nodes} nodes are available: {nodes} node(s) didn't satisfy "
           "the pod's node-static predicates.")
    wrong = [n for n in (f"pod-{i}" for i in range(impossible))
             if res.placements.get(n) != ""
             or res.conditions.get(n) != ("False", "Unschedulable", msg)]
    check(not wrong, f"{name}: {len(wrong)} impossible pods without the "
          f"FitError condition (first {wrong[:3]}: "
          f"{[res.conditions.get(n) for n in wrong[:3]]})")
    check(res.post_filter_runs == 0,
          f"{name}: PostFilter ran {res.post_filter_runs} times")
    log(f"  {name} {nodes} nodes, {impossible} impossible + {pods} pods on "
        f"{res.device}: {res.pods_per_second:.1f} pods/s over "
        f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); the "
        f"{impossible} carry \"{msg}\"; PostFilter runs 0; solves "
        f"{res.solves} rebuilds {res.rebuilds}; kernel busy "
        f"{sum(kernel_ms) / 1000:.3f} s")
    log(f"    host seconds: {_host_split(res)}")
    return {"pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "solves": res.solves, "rebuilds": res.rebuilds,
            "launches": counts, "post_filter_runs": res.post_filter_runs,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds,
            "enqueue_to_bind_ms": res.latency, "kernel_ms": kernel_ms}


def host_port_mix(nodes, pods):
    """Plain pods on 8-cpu nodes, every fifth asking for one of two host
    ports (the serial path places those)."""
    def pod(i):
        d = workloads.basic_pod(i)
        if i % 5 == 0:
            d["spec"]["containers"][0]["ports"] = [
                {"containerPort": 80, "hostPort": 8080 + (i // 5) % 2}]
        return d

    return [{"opcode": "createNodes", "count": nodes,
             "nodeTemplate": lambda i: workloads.node_template(i, cpu="8")},
            {"opcode": "createPods", "count": pods, "podTemplate": pod,
             "collectMetrics": True}]


def phase_small_rows(seed=13):
    """Small Preemption and mixed serial rows on the card and on the CPU:
    the same maps and victims."""
    rows = (("Preemption", lambda: workloads.preemption(50, 50, 50), 64),
            ("host-port mix", lambda: host_port_mix(50, 200), 64))
    for name, ops, max_batch in rows:
        card, _, _, _, _, _ = run_path(
            f"{name} small", lambda: perf.run_workload(
                name, ops(), max_batch=max_batch, device="cuda", seed=seed))
        cpu = perf.run_workload(name, ops(), max_batch=max_batch,
                                device="cpu", seed=seed)
        check(all(card.placements.values()), f"{name} small: all bound")
        check(card.placements == cpu.placements,
              f"{name} small: card and CPU place every pod alike")
        check(card.victims == cpu.victims,
              f"{name} small: card and CPU evict alike")
        log(f"  {name} small: card == CPU on {len(card.placements)} "
            f"placements, {card.victims} victims")


def phase_gang(nodes=5000, pods=30000, gang=10, max_batch=4096):
    """The GangScheduling row pipelined and serialized: checked, and both
    arms bind alike."""
    runs = {}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"GangScheduling {arm}"
        res, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: perf.run_workload(
                "GangScheduling",
                workloads.gang_scheduling(nodes, 0, pods, gang_size=gang),
                max_batch=max_batch, device="cuda", pipeline=pipeline))
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(len(res.placements) == pods, f"{name} created {pods} pods")
        unbound = sum(1 for v in res.placements.values() if not v)
        check(unbound == 0, f"{name}: {unbound} pods left unbound")
        whole = {}
        for pod, node in res.placements.items():
            g = int(pod.split("-")[1]) // gang
            whole[g] = whole.get(g, 0) + bool(node)
        partial = sorted(g for g, n in whole.items() if n != gang)
        check(len(whole) == pods // gang and not partial,
              f"{name}: gangs not bound whole: {partial[:5]}")
        skew = zone_skew(res)
        check(skew <= 5, f"{name}: zone skew {skew} <= 5")
        check(res.waiting_at_end == 0,
              f"{name}: {res.waiting_at_end} pods still waiting at Permit")
        check(not res.conditions, f"{name}: pods failed on the way: "
              f"{list(res.conditions.items())[:3]}")
        check(res.binding["cycles"] == pods - pods // gang
              and res.binding["errors"] == 0,
              f"{name}: binding cycles {res.binding}")
        check(counts["cluster"] == res.solves,
              f"{name}: cluster kernel launches {counts['cluster']} == "
              f"solves {res.solves}")
        mirror = res.mirror_info or {}
        b = res.binding
        busy = sum(kernel_ms) / 1000
        log(f"  {name} {nodes} nodes / {pods} pods in gangs of {gang} on "
            f"{res.device}: {res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"zone skew {skew}")
        log("    enqueue->bind ms p50/p90/p99: " + "/".join(
            f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90", "Perc99")))
        log(f"    solves {res.solves} rebuilds {res.rebuilds} catch-ups "
            f"{mirror.get('catch_ups', 0)} discards "
            f"{(res.pipeline_info or {}).get('discards', 0)}; kernel busy "
            f"{busy:.3f} s; binding pool: {b['cycles']} cycles, "
            f"{b['wait_s']:.3f} s waiting at Permit, {b['bind_s']:.3f} s "
            f"binding (summed over cycles)")
        log(f"    host seconds: {_host_split(res)}")
        runs[arm] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency,
            "solve_to_bind_ms": res.metrics, "zone_skew": skew,
            "solves": res.solves, "rebuilds": res.rebuilds,
            "mirror": res.mirror_info, "pipeline": res.pipeline_info,
            "launches": counts, "kernel_ms": kernel_ms,
            "kernel_busy_s": busy, "binding": b,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds,
            "placements": res.placements}
    check(runs["pipelined"].pop("placements")
          == runs["serialized"].pop("placements"),
          "GangScheduling: both arms bind the same pods to the same nodes")
    log("  pipelined == serialized: bound set")
    return runs


def planned_kernel(ps: PStatic, ints, floats, slots: bool) -> str:
    """The kernel the launch plan gives a recorded launch: a slot stream
    plans with ``packs``; a dense stream plans with ``packs`` when it
    would have packed (at T >= 12), which must not give the slot kernel,
    or the backend routed it wrongly."""
    key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u)
    packs = slots or (ps.t >= solve_mod.SPARSE_MIN_T and not ps.sv
                      and slot_stream(ints.cpu().numpy(),
                                      floats.cpu().numpy(), ps.r, ps.sc,
                                      ps.t) is not None)
    return solve_mod.plan_launch(*key, packs=packs, sv=ps.sv).kernel


def check_plans(name, counts, recorder):
    """Every recorded launch on the kernel the plan gives it; logs each
    shape's plan. Returns the plans by shape."""
    predicted = dict.fromkeys(counts, 0)
    shapes = {}
    for (ps, _, ints, floats), slots in zip(recorder.inputs,
                                             recorder.slots):
        kernel = planned_kernel(ps, ints, floats, slots)
        check(slots == (kernel == "slots"), f"{name}: a launch took the "
              f"{'slot' if slots else 'dense'} stream where the plan "
              f"gives the {kernel} kernel")
        predicted[kernel] += 1
        key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u, ps.sv)
        shapes.setdefault(key, [kernel, 0])[1] += 1
    for (n, r, sc, t, u, sv), (kernel, launches) in shapes.items():
        dense = solve_mod.cluster_candidate(n, r, sc, t, u, sv=sv)
        slots = solve_mod.slots_candidate(n, r, sc, t, u)
        log(f"  plan N={n} R={r} SC={sc} T={t} U={u} SV={sv}: {kernel} "
            f"kernel x "
            f"{launches} launches; a block needs {dense.smem_bytes} B in the "
            f"cluster layout of {dense.cluster}, {slots.smem_bytes} B in the "
            f"slot layout, against {solve_mod.SMEM_LIMIT} B")
    check(counts == predicted, f"{name}: launches {counts} == the plans' "
          f"{predicted}")
    return {str(k): v for k, v in shapes.items()}


def time_slots_batch(name, batch, block_repeats=3, repeats=10):
    """On a slot-route batch: the slot kernel and the one-block kernel
    (forced, on the dense stream the slots were packed from) in turns
    (slots, one-block, one-block, slots), then the plain slot solve and
    the dense plain solve once each; both kernels must equal the plain
    versions. Returns the numbers."""
    kernel = solve_mod.solve_kernel
    ps, state, sints, sfloats = batch
    dints, dfloats = (a.to("cuda") for a in dense_from_slots(ps, sints,
                                                             sfloats))
    kernel.check(ps, state, sints, sfloats, slots=True)
    kernel.check(ps, state, dints, dfloats)
    plans = {"slots": kernel.slots_plan(ps),
             "block": solve_mod.block_plan(ps.ints.shape[1], ps.sc, ps.t)}
    streams = {"slots": (sints, sfloats), "block": (dints, dfloats)}
    turns, finals = {}, {}
    for which in ("slots", "block", "block", "slots"):
        plan, (ints, floats) = plans[which], streams[which]

        def bare(st, plan=plan, ints=ints, floats=floats):
            finals[plan.kernel] = (kernel.launch(PARAMS, ps, st, ints,
                                                 floats, plan), st)

        _event_ms(bare, state, 1)
        turns.setdefault(which, []).append(_event_ms(
            bare, state, repeats if which == "slots" else block_repeats))
    plain = {}
    for which, fn in (("slots", solve_mod.solve_plain_slots),
                      ("block", solve_mod.solve_plain)):
        st = state.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(PARAMS, ps, st, *streams[which])
        torch.cuda.synchronize()
        plain[which] = ((time.perf_counter() - t0) * 1000, got, st)
    errs = {k: _err(finals[k][0], plain[k][1], finals[k][1], plain[k][2])
            for k in finals}
    errs["plain"] = _err(plain["slots"][1], plain["block"][1],
                         plain["slots"][2], plain["block"][2])
    check(not any(errs.values()), f"{name}: both kernels and both plain "
          f"versions agree bit for bit: {errs}")
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    valid = int((sints[:, ps.r + 3] > 0).sum())
    p = plans["slots"]
    b_ms, b_by = bound_ms_slots(*batch)
    block_bound = bound_ms(ps, state, dints, dfloats)
    log(f"  {name} largest batch: N={ps.ints.shape[1]} B={sints.shape[0]} "
        f"valid={valid} T={ps.t}; slot kernel cluster of {p.cluster} x "
        f"{p.cols_per_block} columns, {p.smem_bytes} B shared a block")
    us = {k: v / valid * 1000 for k, v in ms.items()}
    log(f"    slot kernel ms {_ms_list(turns['slots'])}, {us['slots']:.3f} "
        f"us a pod; one-block kernel ms {_ms_list(turns['block'])}, "
        f"{us['block']:.3f} us a pod; plain slot solve {plain['slots'][0]:.1f} ms, dense plain "
        f"{plain['block'][0]:.1f} ms; max_abs_err {errs}; bound "
        f"{b_ms:.6f} ms ({b_by})")
    return {"n": ps.ints.shape[1], "t": ps.t, "valid_pods": valid,
            "ms": ms, "turns": turns,
            "us_per_pod": us,
            "plain_ms": {k: v[0] for k, v in plain.items()},
            "err": max(errs.values()), "bound_ms": b_ms, "bound_by": b_by,
            "block_bound_ms": block_bound[0],
            "block_bound_by": block_bound[1], "plan": p._asdict()}


def phase_anti_affinity(nodes=5000, init=1000, pods=30000, colours=100,
                        max_batch=4096):
    """The SchedulingPodAntiAffinity row: checked, each launch on the
    kernel the plan gives its batch (every T = 100 batch on the slot
    kernel); then on the largest batch the slot kernel, the one-block
    kernel and the plain versions, timed and held against each other.
    Returns the row and the kernel numbers."""
    name = "SchedulingPodAntiAffinity"
    res, counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: perf.run_workload(
            name, workloads.scheduling_pod_anti_affinity(nodes, init, pods),
            max_batch=max_batch, device="cuda"), keep=True, kernel=None)
    measured = [f"pod-{init + i}" for i in range(pods)]
    unbound = [n for n in measured if not res.placements.get(n)]
    check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
    pairs = {(res.placements[f"pod-{init + i}"], (init + i) % colours)
             for i in range(pods)}
    check(len(pairs) == pods, f"{name}: {pods - len(pairs)} nodes hold two "
          "measured pods of one colour")
    plans = check_plans(name, counts, recorder)
    wide = [slots for (ps, _, _, _), slots in zip(recorder.inputs,
                                                   recorder.slots)
            if ps.t >= colours]
    check(wide and all(wide) and counts["block"] == 0,
          f"{name}: every T = {colours} batch ran the slot kernel "
          f"({len(wide)} batches, launches {counts})")
    busy = sum(kernel_ms) / 1000
    log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
        f"{res.pods_per_second:.1f} pods/s over {res.duration_seconds:.3f} s "
        f"(whole run {wall:.1f} s); launches {counts}; kernel busy "
        f"{busy:.3f} s")
    log("    enqueue->bind ms p50/p90/p99: " + "/".join(
        f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90", "Perc99")))
    log(f"    kernel ms (wrapper call) {_ms_list(kernel_ms)}")
    log(f"    solves {res.solves} rebuilds {res.rebuilds} catch-ups "
        f"{(res.mirror_info or {}).get('catch_ups', 0)}; host seconds: "
        f"{_host_split(res)}")
    timed = time_slots_batch(name, recorder.largest(slots=True))
    return {
        "pods_per_s": res.pods_per_second,
        "duration_s": res.duration_seconds, "wall_s": wall,
        "enqueue_to_bind_ms": res.latency, "solve_to_bind_ms": res.metrics,
        "solves": res.solves, "rebuilds": res.rebuilds,
        "mirror": res.mirror_info, "launches": counts,
        "kernel_ms": kernel_ms, "kernel_busy_s": busy,
        "host_paths_s": res.host_paths, "host_seconds": res.seconds,
        "plans": plans,
    }, timed


WIDE_FAMILIES = ("SchedulingPodAffinity", "SchedulingPreferredPodAffinity",
                 "SchedulingPreferredPodAntiAffinity")


def phase_wide_terms(nodes=5000, init=5000, pods=1000, max_batch=4096):
    """The three other wide-term families at bench.py's sizes: every
    measured pod bound, each required-affinity pod in a zone holding a
    pod of its group, every launch as planned (the measured batches on
    the slot kernel), and the slot kernel equal to the plain slot solve
    on each row's largest batch. Returns the rows and the largest
    slot-kernel error."""
    rows, worst = {}, 0
    for name in WIDE_FAMILIES:
        res, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: perf.run_workload(
                name, workloads.make_workload(name, nodes, init, pods),
                max_batch=max_batch, device="cuda"), keep=True, kernel=None)
        measured = [init + i for i in range(pods)]
        unbound = [i for i in measured if not res.placements.get(f"pod-{i}")]
        check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
        if name == "SchedulingPodAffinity":
            zone = {i: int(res.placements[f"pod-{i}"].split("-")[1]) % 10
                    for i in range(init + pods)}
            together = {}
            for i, z in zone.items():
                together[i % 50, z] = together.get((i % 50, z), 0) + 1
            apart = [i for i in measured if together[i % 50, zone[i]] < 2]
            check(not apart, f"{name}: {len(apart)} measured pods in a zone "
                  "without another pod of their group")
        plans = check_plans(name, counts, recorder)
        check(counts["slots"] > 0 and counts["block"] == 0,
              f"{name}: the measured batches ran the slot kernel: {counts}")
        ps, state, ints, floats = recorder.largest(slots=True)
        got, st, _ = _solve_on_card(ps, state, ints, floats,
                                    solve_mod.solve_kernel.slots_plan(ps))
        b = on("cuda", ps, state, ints, floats)
        want = solve_mod.solve_plain_slots(PARAMS, *b)
        err = _err(got, want, st, b[1])
        check(err == 0, f"{name}: slot kernel equals plain on its largest "
              "batch")
        worst = max(worst, err)
        busy = sum(kernel_ms) / 1000
        log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"launches {counts}; kernel ms {_ms_list(kernel_ms)} (busy "
            f"{busy:.3f} s); max_abs_err {err}")
        log(f"    enqueue->bind ms p50/p99: {res.latency['Perc50']:.1f}/"
            f"{res.latency['Perc99']:.1f}; solves {res.solves} rebuilds "
            f"{res.rebuilds}; host seconds: {_host_split(res)}")
        rows[name] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency, "solves": res.solves,
            "rebuilds": res.rebuilds, "launches": counts,
            "kernel_ms": kernel_ms, "kernel_busy_s": busy, "plans": plans,
            "host_seconds": res.seconds, "max_abs_err": err}
    return rows, worst


PV_ROWS = (("SchedulingInTreePVs", 1000, 0, 5000),
           ("SchedulingMigratedInTreePVs", 1000, 0, 5000),
           ("SchedulingCSIPVs", 1000, 0, 5000),
           ("SchedulingSharedPVs", 1000, 0, 3000))


def _row_numbers(res, counts, kernel_ms, wall):
    busy = sum(kernel_ms) / 1000
    return {"pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds, "wall_s": wall,
            "enqueue_to_bind_ms": res.latency, "solves": res.solves,
            "rebuilds": res.rebuilds, "launches": counts,
            "kernel_ms": kernel_ms, "kernel_busy_s": busy,
            "host_paths_s": res.host_paths, "host_seconds": res.seconds}


def phase_pv_rows(max_batch=4096):
    """The four PV rows at bench.py's sizes: every measured pod bound, no
    node over the CSINode limit, every WaitForFirstConsumer claim bound to
    a PV of its own, the launches as planned."""
    rows = {}
    for name, nodes, init, pods in PV_ROWS:
        res, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: perf.run_workload(
                name, workloads.make_workload(name, nodes, init, pods),
                max_batch=max_batch, device="cuda"), keep=True, kernel=None)
        measured = [f"pod-{init + i}" for i in range(pods)]
        unbound = [n for n in measured if not res.placements.get(n)]
        check(not unbound, f"{name}: {len(unbound)} measured pods unbound")
        most = max(len(v) for v in res.node_volumes.values())
        if name == "SchedulingCSIPVs":
            # every PV of the row is a csi.fake.driver volume
            check(most <= 39, f"{name}: a node holds {most} csi.fake.driver "
                  "volumes, over its limit of 39")
        wfc = [pv for c, pv in res.claims.items() if c.startswith("claim-")]
        check(all(wfc) and len(set(wfc)) == len(wfc),
              f"{name}: every claim bound to a PV of its own")
        if name == "SchedulingSharedPVs":
            check(res.volumes_bound == len(wfc) > 0,
                  f"{name}: {res.volumes_bound} claims bound at commit for "
                  f"{len(wfc)} WaitForFirstConsumer claims")
        plans = check_plans(name, counts, recorder)
        row = _row_numbers(res, counts, kernel_ms, wall)
        row.update(plans=plans, most_volumes_a_node=most,
                   volumes_bound_at_commit=res.volumes_bound)
        log(f"  {name} {nodes} nodes / {init} / {pods} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"launches {counts}; kernel busy {row['kernel_busy_s']:.3f} s; "
            f"most volumes a node {most}; claims bound at commit "
            f"{res.volumes_bound}")
        log("    enqueue->bind ms p50/p90/p99: " + "/".join(
            f"{res.latency[k]:.1f}" for k in ("Perc50", "Perc90", "Perc99"))
            + f"; solves {res.solves} rebuilds {res.rebuilds}; host "
            f"seconds: {_host_split(res)}")
        rows[name] = row
    return rows


def phase_preemption_pvs(nodes=5000, seed=11, max_batch=4096):
    """PreemptionPVs in the default arms and serialized: checked as the
    Preemption row, both arms bind and evict alike, and every claim is
    still bound to its PV."""
    runs, sets = {}, {}
    want_claims = {f"claim-{nodes + i}": f"pv-{nodes + i}"
                   for i in range(nodes)}
    for pipeline in (True, False):
        arm = "pipelined" if pipeline else "serialized"
        name = f"PreemptionPVs {arm}"
        res, counts, kernel_ms, _, _, wall = run_path(
            name, lambda: perf.run_workload(
                "PreemptionPVs", workloads.preemption_pvs(nodes, nodes,
                                                          nodes),
                max_batch=max_batch, device="cuda", pipeline=pipeline,
                seed=seed))
        check(res.pipeline == pipeline, f"{name} ran the {arm} arm")
        check(counts["cluster"] == res.solves,
              f"{name}: cluster kernel launches {counts['cluster']} == "
              f"solves {res.solves}")
        sets[arm] = check_preemption_row(name, res, nodes)
        check(res.claims == want_claims,
              f"{name}: every claim still bound to its PV")
        runs[arm] = _row_numbers(res, counts, kernel_ms, wall)
        runs[arm].update(victims=res.victims,
                         post_filter_runs=res.post_filter_runs)
        log(f"  {name} {nodes} nodes / {nodes} / {nodes} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"{res.victims} victims, PostFilter runs {res.post_filter_runs}; "
            f"solves {res.solves} rebuilds {res.rebuilds}; kernel busy "
            f"{runs[arm]['kernel_busy_s']:.3f} s")
        log("    enqueue->bind ms p50/p99: "
            f"{res.latency['Perc50']:.1f}/{res.latency['Perc99']:.1f}; host "
            f"seconds: {_host_split(res)}")
    check(sets["pipelined"] == sets["serialized"],
          "PreemptionPVs: both arms bind the same pods to the same nodes and "
          "evict the same pods")
    log("  pipelined == serialized: bound set and victim set")
    return runs


SHARED_DRIVER = "rwx.csi.example.com"


def shared_volume_store(nodes, claims, limit):
    """The JAX package's shared-volume test fixture, grown: ``nodes``
    SchedulingBasic nodes with a CSINode limit of ``limit`` for one
    driver, and ``claims`` shared ReadWriteMany CSI claims, each bound to
    its PV."""
    store = ClusterStore()
    for i in range(nodes):
        store.add_node(Node.from_dict(workloads.node_template(i)))
        store.add_csi_node(CSINode(
            metadata=ObjectMeta(name=f"node-{i}"),
            drivers=[CSINodeDriver(name=SHARED_DRIVER, node_id=f"node-{i}",
                                   allocatable_count=limit)]))
    store.add_storage_class(StorageClass(
        metadata=ObjectMeta(name="shared-csi"), provisioner=SHARED_DRIVER))
    for c in range(claims):
        store.add_pv(PersistentVolume(
            metadata=ObjectMeta(name=f"pv-shared-{c}"),
            capacity={"storage": parse_quantity("10Gi")},
            access_modes=["ReadWriteMany"], storage_class_name="shared-csi",
            claim_ref=f"default/shared-{c}", phase="Bound",
            csi_driver=SHARED_DRIVER))
        store.add_pvc(PersistentVolumeClaim(
            metadata=ObjectMeta(name=f"shared-{c}", namespace="default"),
            storage_class_name="shared-csi", access_modes=["ReadWriteMany"],
            requests={"storage": parse_quantity("1Gi")},
            volume_name=f"pv-shared-{c}", phase="Bound"))
    return store


def run_shared_volumes(device, nodes, claims, pods, limit, max_batch):
    """``pods`` pods, pod i on claim i mod ``claims`` (so once every node
    holds ``limit`` volumes, the later pods fit only where their volume is
    already attached), through the batch loop on
    ``device`` in batches of ``max_batch``. Returns (store, batch loop,
    pod dicts); the scheduler is stopped."""
    store = shared_volume_store(nodes, claims, limit)
    sched = Scheduler(store, config=SchedulerConfiguration(
        provider="GangSchedulingProvider"))
    get_tracer().clear()
    get_devprof().reset(workload="shared volumes")
    perf.reset_sli_window()
    bs = BatchScheduler(sched, max_batch=max_batch, device=device)
    sched.start()
    dicts = []
    for i in range(pods):
        d = workloads.basic_pod(i)
        d["spec"]["volumes"] = [{"name": "data", "persistentVolumeClaim": {
            "claimName": f"shared-{i % claims}"}}]
        dicts.append(d)
    try:
        # one pod a claim: the warm-up's epoch has every volume's slot
        bs.warmup([Pod.from_dict(d) for d in dicts[:claims]])
        store.create_pods([Pod.from_dict(d) for d in dicts])
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            sched.queue.flush_backoff_completed()
            if bs.run_batch(pop_timeout=0.0):
                continue
            if sched.queue.pending_active_count() == 0 and not bs.holding:
                break
            time.sleep(0.005)
        bs.flush()
        check(sched.wait_for_inflight_bindings(timeout=60.0),
              "shared volumes: bindings settled")
    finally:
        sched.stop()
    telemetry = get_devprof().summary()
    row_report("shared volumes", str(bs.session.backend.device), {
        "telemetry": telemetry,
        "critical_path": perf.collect_critical_path()[0],
        "freshness": perf.collect_freshness(telemetry)})
    return store, bs, dicts


def phase_shared_volumes(nodes=1000, claims=300, pods=3000, limit=2,
                         max_batch=1024):
    """The shared-volume attach planes at size: checked, the carried
    planes equal to a fresh prepare's, and the cluster kernel, the
    one-block kernel and the plain version on the largest batch."""
    name = "shared volumes"
    (store, bs, dicts), counts, kernel_ms, _, recorder, wall = run_path(
        name, lambda: run_shared_volumes("cuda", nodes, claims, pods, limit,
                                         max_batch), keep=True)
    bound = {p.metadata.name: p.spec.node_name for p in store.list_pods()}
    unbound = [n for n, v in bound.items() if not v]
    check(len(bound) == pods and not unbound,
          f"{name}: {len(unbound)} of {pods} pods unbound")
    per_node = {}
    for p in store.list_pods():
        per_node.setdefault(p.spec.node_name, set()).add(
            p.spec.volumes[0].persistent_volume_claim)
    most = max(len(v) for v in per_node.values())
    check(most <= limit, f"{name}: a node holds {most} shared volumes, over "
          f"its limit of {limit}")
    svs = {ps.sv for ps, _, _, _ in recorder.inputs}
    want_sv = max(8, 1 << (claims - 1).bit_length())   # 512 for 300
    check(svs == {want_sv}, f"{name}: every launch with SV = {want_sv} "
          f"({svs})")
    session = bs.session
    check(session.mirror_current(), f"{name}: the carried state is current")
    sample = [Pod.from_dict(dicts[0])]
    fresh_static, fresh = session.fresh_planes(sample, max_batch)
    ps = session._static
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    col = ps.r - 1
    rows = list(range(do["sv_attached"], do["sv_attached"] + ps.sv)) + [
        do["requested"] + col]
    check(fresh_static.sv == ps.sv, f"{name}: fresh planes' SV")
    err = int((session._state[rows] - fresh[rows]).abs().max())
    check(err == 0, f"{name}: the carried sv planes and attach column equal "
          "a fresh prepare's")
    attached = int(session._state[rows[:-1]].sum())
    busy = sum(kernel_ms) / 1000
    log(f"  {name}: {nodes} nodes (limit {limit}), {claims} claims, {pods} "
        f"pods in batches of {max_batch}: all bound in {wall:.1f} s; "
        f"launches {counts}; kernel ms {_ms_list(kernel_ms)}; most shared "
        f"volumes a node {most}; {attached} attachments; carried planes "
        f"equal a fresh prepare's")
    largest = recorder.largest()
    timed, final = time_batch(f"{name} largest batch", largest)
    plain_ms, plain_err = plain_against(f"{name} largest", largest, final)
    b_ms, b_by = bound_ms(*largest)
    log(f"  bound on the shared-volume batch {b_ms:.6f} ms ({b_by})")
    return {"wall_s": wall, "launches": counts, "kernel_ms": kernel_ms,
            "kernel_busy_s": busy, "most_volumes_a_node": most,
            "attachments": attached, "timed": timed, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "err": max(timed["err"], plain_err)}

# every row's telemetry, critical path and freshness, in the order run
ROW_REPORTS = []


def row_report(name, device, res):
    """Log a row's ``telemetry``, ``critical_path`` and ``freshness`` (a
    ``BenchmarkResult`` or a sustained row's dict) as one JSON line; on
    the card, no compile may land inside a measured cycle."""
    get = res.get if isinstance(res, dict) else (
        lambda k: getattr(res, k))
    report = {"row": name, "device": device,
              "telemetry": get("telemetry"),
              "critical_path": get("critical_path"),
              "freshness": get("freshness"),
              # the span totals of the row's ring: count, seconds
              "spans": {k: [v["count"], round(v["total_s"], 6)] for k, v
                        in sorted(get_tracer().phase_stats().items())}}
    ROW_REPORTS.append(report)
    print("row " + json.dumps(report, default=str), flush=True)
    telemetry = report["telemetry"] or {}
    if device.startswith("cuda") and telemetry:
        check(telemetry["unexpected_compiles"] == 0,
              f"{name}: {telemetry['unexpected_compiles']} compiles inside "
              "measured cycles")
    return report


def observe_rows():
    """Wrap ``perf.run_workload`` and ``sustained.run_sustained_row`` so
    every row any phase runs reports (``row_report``)."""
    run_workload, run_sustained = perf.run_workload, \
        sustained.run_sustained_row

    def observed_workload(name, ops, **kw):
        res = run_workload(name, ops, **kw)
        row_report(name, res.device, res)
        return res

    def observed_sustained(**kw):
        row = run_sustained(**kw)
        row_report("sustained", row["device"], row)
        return row

    perf.run_workload = observed_workload
    sustained.run_sustained_row = observed_sustained


def check_attribution(name, res, bar=0.05):
    """The row's aggregate unattributed share of the sampled pods'
    windows at most ``bar`` (the JAX package's bar for batch rows)."""
    cp = res.critical_path
    check(cp.get("pods", 0) > 0, f"{name}: sampled pods in the critical "
          "path")
    share = cp["unattributed_share"]
    check(share <= bar, f"{name}: unattributed share {share} > {bar}")
    log(f"    critical path over {cp['pods']} sampled pods: "
        + ", ".join(f"{k}={v}" for k, v in cp["phase_shares"].items())
        + f"; unattributed {share}")


CONFIG_ROWS = (("SchedulingBasic", 100, 1000),      # BASELINE config 1
               ("SchedulingBasic", 1000, 10000),    # config 2
               ("TopologySpreading", 5000, 30000))  # config 3


def phase_configs():
    """BASELINE configs 1-3 as named rows on the card: every pod bound,
    the cluster kernel once per solve; config 3's zone skew at most
    one."""
    rows = {}
    for name, nodes, pods in CONFIG_ROWS:
        res, counts, kernel_ms, _ = run_main_path(name, nodes, pods)
        if name == "TopologySpreading":
            skew = zone_skew(res)
            check(skew <= 1, f"{name} zone skew {skew} <= 1")
            log(f"  zone skew {skew}")
        rows[f"{name} {nodes}/{pods}"] = {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds,
            "enqueue_to_bind_ms": res.latency, "solves": res.solves,
            "launches": counts, "kernel_ms": kernel_ms,
            "host_seconds": res.seconds, "telemetry": res.telemetry,
            "critical_path": res.critical_path}
    return rows


FAMILIES = (("SchedulingSecrets", 5000, 5000, 1000),
            ("SchedulingNodeAffinity", 5000, 5000, 1000),
            ("PreferredTopologySpreading", 5000, 5000, 2000),
            ("MixedSchedulingBasePod", 5000, 1000, 30000))


def phase_families(max_batch=4096):
    """The four families ported last, at bench.py's sizes: every pod
    bound (measured and init), each node-affinity pod in its zone, every
    launch on the kernel its plan gives it."""
    rows = {}
    for name, nodes, init, pods in FAMILIES:
        res, counts, kernel_ms, _, recorder, wall = run_path(
            name, lambda: perf.run_workload(
                name, workloads.make_workload(name, nodes, init, pods),
                max_batch=max_batch, device="cuda"), keep=True, kernel=None)
        unbound = [k for k, v in res.placements.items() if not v]
        check(len(res.placements) == init + pods and not unbound,
              f"{name}: {len(unbound)} of {init + pods} pods unbound")
        if name == "SchedulingNodeAffinity":
            off = [i for i in range(init, init + pods)
                   if int(res.placements[f"pod-{i}"].split("-")[1]) % 10
                   != i % 10]
            check(not off, f"{name}: {len(off)} pods outside their zone")
        plans = check_plans(name, counts, recorder)
        busy = sum(kernel_ms) / 1000
        log(f"  {name} {nodes} / {init} / {pods} on {res.device}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s (whole run {wall:.1f} s); "
            f"launches {counts}; kernel busy {busy:.3f} s; enqueue->bind "
            f"p99 {res.latency['Perc99']:.1f} ms; host seconds: "
            f"{_host_split(res)}")
        rows[name] = {**_row_numbers(res, counts, kernel_ms, wall),
                      "plans": plans, "telemetry": res.telemetry,
                      "critical_path": res.critical_path}
    return rows


def phase_tracing_cost(nodes=5000, pods=30000, max_batch=4096):
    """SchedulingBasic pipelined with the tracer and the device profiler
    on and off (``KTPU_TRACE=off``, ``KTPU_DEVPROF=off`` in process), in
    turns: on, off, off, on. Every pod bound in every turn; the off turns
    record nothing."""
    tracer, prof = get_tracer(), get_devprof()
    turns = []
    for on_ in (True, False, False, True):
        tracer.configure(enabled=on_)
        prof.configure(enabled=on_)
        try:
            res, counts, kernel_ms, _ = run_main_path(
                "SchedulingBasic", nodes, pods, max_batch)
        finally:
            tracer.configure(enabled=True)
            prof.configure(enabled=True)
        check(bool(res.telemetry) == on_ and bool(res.critical_path) == on_,
              f"tracing {'on' if on_ else 'off'}: the row's telemetry and "
              "critical path present only with tracing on")
        turns.append({"tracing": on_, "pods_per_s": res.pods_per_second,
                      "duration_s": res.duration_seconds,
                      "enqueue_to_bind_ms": res.latency,
                      "solves": res.solves,
                      "kernel_busy_s": sum(kernel_ms) / 1000})
        log(f"  tracing {'on ' if on_ else 'off'}: "
            f"{res.pods_per_second:.1f} pods/s over "
            f"{res.duration_seconds:.3f} s, enqueue->bind p99 "
            f"{res.latency['Perc99']:.1f} ms")
    return turns


def phase_tuner(nodes=5000, pods=12000, max_batch=4096):
    """The latency-budget tuner forced to shrink: SchedulingBasic with
    the instance's budget cut to 1 µs after its warm-up (which warmed 4096
    and 2048). The pad steps down one bucket a batch to ``MIN_CHUNK``;
    each bucket the warm-up did not warm is warmed by ``warm_pad``
    between cycles before its first solve; no compile lands in a measured
    cycle. The row starts cold: its warm-up books the kernel's first
    launch and the pinned staging buffers, and no smaller pad allocates
    any after it (nor its warm: a smaller pad's streams are views of the
    buffers held). Every pod bound."""
    pads, warms, allocated = [], [], []

    def configure(bs):
        warmup, solve = bs.warmup, bs.session.solve
        warm_pad = bs.session.warm_pad

        def cut_after_warmup(samples):
            before = len(solve_mod.STAGING.allocations)
            out = warmup(samples)
            bs.LATENCY_BUDGET_S = 1e-6
            allocated.append(solve_mod.STAGING.allocations[before:])
            allocated.append(len(solve_mod.STAGING.allocations))
            return out

        def solve_at(pods_, pad, **kw):
            if not kw.get("warming"):
                pads.append(pad)
            return solve(pods_, pad, **kw)

        def warm_pad_at(pods_, pad):
            t0 = time.monotonic()
            got = warm_pad(pods_, pad)
            warms.append({"pad": pad, "solves_before": len(pads),
                          "compiles": got,
                          "ms": (time.monotonic() - t0) * 1000})
            return got

        bs.warmup, bs.session.solve = cut_after_warmup, solve_at
        bs.session.warm_pad = warm_pad_at

    name = "SchedulingBasic tuner"
    res, counts, kernel_ms, _, _, wall = run_path(
        name, lambda: perf.run_workload(
            "SchedulingBasic", workloads.make_workload(
                "SchedulingBasic", nodes, 0, pods),
            max_batch=max_batch, device="cuda", configure=configure),
        cold=True)
    check(all(res.placements.values()), f"{name}: every pod bound")
    check(all(b in (a, a // 2) for a, b in zip(pads, pads[1:])),
          f"{name}: the pad moved more than one bucket a batch: {pads}")
    between = [w for w in warms if w["solves_before"] > 0]
    for w in between:
        check(w["pad"] not in pads[:w["solves_before"]],
              f"{name}: pad {w['pad']} solved before its warm")
        check(w["compiles"] == 0, f"{name}: the warm of pad {w['pad']} "
              f"booked {w['compiles']} compiles")
    check(res.chunk == 512 and {1024, 512} <= {w["pad"] for w in between},
          f"{name}: chunk {res.chunk}, warms between cycles {between}")
    check(res.telemetry["unexpected_compiles"] == 0,
          f"{name}: a compile inside a measured cycle")
    check(res.telemetry["warm_compiles"] >= 3 and len(allocated[0]) >= 2,
          f"{name}: the cold warm-up booked {res.telemetry['warm_compiles']}"
          f" compiles, {len(allocated[0])} staging allocations")
    after = solve_mod.STAGING.allocations[allocated[1]:]
    check(not after, f"{name}: staging allocations after the warm-up: "
          f"{after}")
    log(f"  {name}: pads {pads}; warms {warms}; chunk {res.chunk}; "
        f"warmed {res.warmed_pads}; warm-up compiles "
        f"{res.telemetry['warm_compiles']}, staging allocations "
        f"{allocated[0]}; {res.pods_per_second:.1f} pods/s over "
        f"{res.duration_seconds:.3f} s; enqueue->bind p99 "
        f"{res.latency['Perc99']:.1f} ms")
    return {"pads": pads, "warms": warms, "chunk": res.chunk,
            "warmed_pads": res.warmed_pads, "launches": counts,
            "staging_allocations": allocated[0],
            "pods_per_s": res.pods_per_second,
            "enqueue_to_bind_ms": res.latency, "wall_s": wall,
            "telemetry": res.telemetry}


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    card = gpu_name_and_power()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}")

    t0 = time.monotonic()
    lib = solve_mod.build_kernel()
    log(f"[2] built {lib.name} from {KERNEL_SOURCE} in "
        f"{time.monotonic() - t0:.1f} s")
    print_ptxas(lib)

    log("[3] kernels against plain on seeded problems")
    errs = phase_compare()

    observe_rows()
    log("[4] main path: SchedulingBasic (pipelined, mirror on)")
    res, counts, kernel_ms, largest = run_main_path(
        "SchedulingBasic", 5000, 30000)
    check_attribution("SchedulingBasic", res)

    log("[5] TopologySpreading")
    spread, spread_counts, spread_ms, spread_largest = run_main_path(
        "TopologySpreading", 5000, 5000)
    skew = zone_skew(spread)
    check(skew <= 1, f"TopologySpreading zone skew {skew} <= 1")
    log(f"  zone skew {skew}")

    log("[6] small slices: card against CPU")
    phase_small_slices()

    log("[7] kernel timing: both kernels in turns")
    batches = {"SchedulingBasic": largest,
               "TopologySpreading": spread_largest,
               "SchedulingBasic@1024": cut_columns(largest, 1024)}
    timings, finals = {}, {}
    for name, batch in batches.items():
        timings[name], finals[name] = time_batch(name + " largest batch",
                                                 batch)
    sb = timings["SchedulingBasic"]
    split = split_per_pod(sb, timings["SchedulingBasic@1024"])
    sweep = {"SchedulingBasic": cluster_sweep("SchedulingBasic", largest),
             "TopologySpreading": cluster_sweep("TopologySpreading",
                                                spread_largest)}
    plain_ms, err = plain_against("SchedulingBasic", largest,
                                  finals["SchedulingBasic"])
    errs["cluster"] = max(errs["cluster"], err)
    _, err = plain_against("TopologySpreading", spread_largest,
                           finals["TopologySpreading"])
    errs["cluster"] = max(errs["cluster"], err)
    b_ms, b_by = bound_ms(*largest)
    log(f"  bound on the SchedulingBasic batch {b_ms:.6f} ms ({b_by})")
    for t in timings.values():
        for k in errs:
            errs[k] = max(errs[k], t["err"])

    log("[8] pipelined against serialized: SchedulingBasic, in turns")
    pipeline_runs = phase_pipeline()

    log("[9] the churn path, mirror on and off")
    churn = phase_churn()

    log("[10] the sustained-arrival row, pipelined and serialized")
    sustained_rows = phase_sustained()

    log("[11] the Preemption row, pipelined and serialized")
    preemption = phase_preemption()

    log("[12] the Unschedulable row")
    unschedulable = phase_unschedulable()

    log("[13] small Preemption and mixed serial rows: card against CPU")
    phase_small_rows()

    log("[14] the GangScheduling row, pipelined and serialized")
    gang = phase_gang()

    log("[15] the SchedulingPodAntiAffinity row")
    anti, slots = phase_anti_affinity()
    for k in ("slots", "block"):
        errs[k] = max(errs[k], slots["err"])

    log("[16] the wide-term families: SchedulingPodAffinity, "
        "SchedulingPreferredPodAffinity, SchedulingPreferredPodAntiAffinity")
    wide, wide_err = phase_wide_terms()
    errs["slots"] = max(errs["slots"], wide_err)

    log("[17] the PV rows: SchedulingInTreePVs, SchedulingMigratedInTreePVs, "
        "SchedulingCSIPVs, SchedulingSharedPVs")
    pv_rows = phase_pv_rows()

    log("[18] PreemptionPVs, pipelined and serialized")
    preemption_pvs = phase_preemption_pvs()

    log("[19] the shared-volume attach planes at size")
    shared = phase_shared_volumes()
    for k in ("cluster", "block"):
        errs[k] = max(errs[k], shared["err"])

    log("[20] BASELINE configs 1-3: SchedulingBasic 100/1,000 and "
        "1,000/10,000, TopologySpreading 5,000/30,000")
    configs = phase_configs()

    log("[21] SchedulingSecrets, SchedulingNodeAffinity, "
        "PreferredTopologySpreading, MixedSchedulingBasePod")
    families = phase_families()

    log("[22] the tracer's cost: SchedulingBasic with tracing on, off, off, "
        "on")
    tracing = phase_tracing_cost()

    log("[23] the latency-budget tuner forced to shrink")
    tuner = phase_tuner()
    log(f"  main-path launches over phases 4, 5 and 8 to 23: {LAUNCHES}")

    scatters = {"scatters": {
        arm: {"counts": r["scatters"], "host_s": r["host_seconds"]["scatter"],
              "device_ms": {k: sum(v) for k, v in
                            r["scatter_device_ms"].items()},
              "bound_ms": {k: sum(v) for k, v in
                           r["scatter_bound_ms"].items()}}
        for arm, r in churn.items()}}
    # each kernel on the largest batch of a main path it runs on
    sv_timed = shared["timed"]
    timed = {
        "cluster": {"ms": sb["ms"]["cluster"], "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "batch": "SchedulingBasic largest batch",
                    "carries": "the sv attach planes",
                    "sv_ms": sv_timed["ms"]["cluster"],
                    "sv_plain_ms": shared["plain_ms"],
                    "sv_bound_ms": shared["bound_ms"],
                    "sv_bound_by": shared["bound_by"],
                    "sv_batch": f"shared-volume phase largest batch "
                                f"(SV=512, {sv_timed['valid_pods']} pods)"},
        "slots": {"ms": slots["ms"]["slots"],
                  "plain_ms": slots["plain_ms"]["slots"],
                  "bound_ms": slots["bound_ms"], "bound_by": slots["bound_by"],
                  "batch": f"SchedulingPodAntiAffinity largest batch "
                           f"(T={slots['t']}), slot stream"},
        "block": {"ms": slots["ms"]["block"],
                  "plain_ms": slots["plain_ms"]["block"],
                  "bound_ms": slots["block_bound_ms"],
                  "bound_by": slots["block_bound_by"],
                  "batch": f"SchedulingPodAntiAffinity largest batch "
                           f"(T={slots['t']}), dense stream, forced",
                  "carries": "the sv attach planes",
                  "sv_ms": sv_timed["ms"]["block"],
                  "sv_batch": "shared-volume phase largest batch, forced"}}
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": replaces, "launches": LAUNCHES[k],
        "max_abs_err": float(errs[k]), **timed[k], "library_ms": None,
        "library_ms_reason": "no single PyTorch call computes the solve",
    } for k, name, replaces in (
        ("cluster", "solve_cluster_kernel", REPLACES),
        ("slots", "solve_slots_kernel", REPLACES_SPARSE),
        ("block", "solve_block_kernel", REPLACES))]}
    report = {
        "card": card, "kernels": kernels["kernels"],
        "scheduling_basic": {
            "pods_per_s": res.pods_per_second,
            "duration_s": res.duration_seconds,
            "enqueue_to_bind_ms": res.latency, "solve_to_bind_ms": res.metrics,
            "solves": res.solves, "rebuilds": res.rebuilds,
            "kernel_ms": kernel_ms, "host_seconds": res.seconds},
        "timings": timings, "per_pod_split_us_ns": split,
        "cluster_sweep_ms": sweep,
        "topology_spreading": {
            "pods_per_s": spread.pods_per_second,
            "duration_s": spread.duration_seconds,
            "enqueue_to_bind_ms": spread.latency, "zone_skew": skew,
            "solves": spread.solves, "launches": spread_counts,
            "kernel_ms": spread_ms, "host_seconds": spread.seconds},
        "launches_by_path": LAUNCHES, "pipeline_runs": pipeline_runs,
        "churn": churn, "sustained": sustained_rows,
        "preemption": preemption, "unschedulable": unschedulable,
        "gang": gang, "anti_affinity": anti, "slot_kernel": slots,
        "wide_terms": wide, "pv_rows": pv_rows,
        "preemption_pvs": preemption_pvs, "shared_volumes": shared,
        "scatters": scatters["scatters"], "configs": configs,
        "families": families, "tracing_cost": tracing, "tuner": tuner,
        "rows": ROW_REPORTS,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps(scatters), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
