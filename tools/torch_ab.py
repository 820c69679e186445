"""Parent against change on the card: the rows a batch-loop change moves.

Runs, from the PyTorch package found under ``--tree`` (a checkout of the
repo; by default this one), SchedulingBasic at 5,000 nodes / 30,000 pods,
the sustained-arrival row (30,000 pods offered at 5,000/s) and Preemption
at 5,000 / 5,000 / 5,000, each in its default arms (pipelined, mirror
on), through the same harness calls ``chip_smoke.py`` makes. Checks that
every measured pod is bound (and, on the sustained row, none lost), and
prints one JSON line: the card, and per row pods/s and latency
percentiles. The kernels are built before the first row.

The ``scan`` row times the scan kernel (the autoscaler's what-if) with
ten bare launches, CUDA events around each, on two inputs: the fixed
yardstick ``whatif_problem(10, n_nodes=94, n_upcoming=162,
n_virtual=256, n_pods=2000, pad=2048)`` (N = 512, with constraints) and
the autoscale row's largest what-if shape (94 full nodes of 32 cpu, 162
booting and 256 new ones, 2,048 pending pods of 500m; N = 512, no
constraints; ``harness/problems.py::autoscale_whatif``, so a tree from
before that function cannot run this row). Every launch must give the same result; its digest (sha256 of
the assignments and final state) lets two trees be held bit for bit.

The ``kernels`` row does the same for the cluster kernel
(``random_planes(32, 5120, 4096)``, T = 1), the slot kernel (the
slot stream of ``random_slot_planes(33, 5120, 4096, 100)``) and the
wide kernel forced on that batch's dense stream, whose sources they
share; and on the SchedulingBasic batch (4,096 ``basic_pod``s over
5,000 ``node_template`` nodes, the batch of ``chip_smoke.py``'s phase
29 (c)), the cluster kernel, the wide kernel forced and the sharded
kernel at 1, 2 and 4 shards (``shard_planes``, each tree's own
``sharded_plan``), digests over the assignments, the planes and each
shard's totals, and the feasibility counts kernel at 4 shards, through
its wrapper and alone (its C entry, launches queued back to back), with
a digest of the counts. Last, slot-route batches on the kernel each tree routes
them to (the slot kernel on the slot stream where the tree plans it,
else its plan on the dense stream): phase 15's first batch (4,096
SchedulingPodAntiAffinity pods over 5,000 nodes, T = 100, one term
reference a pod) and 4,096 pods of exactly 1 or 8 references at T =
100 over 10,240 and 20,480 columns (``SLOT_SHAPES``, ``_refs_planes``).

The ``counts`` row times the feasibility counts kernel alone: the
SchedulingBasic batch at 4 shards as in the ``kernels`` row, then
``random_planes`` inputs from 32 pods over 128 columns to 4,096 pods over
5,120 columns (``COUNTS_SHAPES``; the last at R = 4), one shard, so that
the launch's fixed cost shows beside the part that grows with pods x
columns.

The ``wide`` row does the same for the dense solve past the cluster
kernel's shared memory, on the kernel the tree's ``plan_launch`` picks
(the one-block kernel before the wide kernel replaced it): input A is
``random_planes(30, 5120, 4096, t=100)`` with pod 3 rewritten to nine
term references (the dense stream: a batch that does not pack), input B
``random_planes(31, 1024, 1024, r=4, t=100, sv=64)`` (shared-volume
slots). The ``config`` row is ``chip_smoke.py``'s phase 30a
(``harness/ha.py::config_row`` at 5,000 nodes / 30,000 pods, every
200th pod the extender's or the packing profile's; a tree from before
that module cannot run it). The ``widepods`` row runs the
SchedulingPodAntiAffinity row at 5,000 nodes / 1,000 / 30,000 with
every 64th measured pod also carrying 12 weighted preferred
pod-affinity terms (built here from the tree's
``harness/workloads.py``, as ``chip_smoke.py``'s phase 28 builds it),
and prints pods/s, latency percentiles, the launches by kernel and each
launch's ms (CUDA events around the wrapper's call).

Compare two commits in one call, in turns, one process a run:

    git archive <parent> | tar -x -C chip_proof/parent
    for t in chip_proof/parent . . chip_proof/parent; do
        python3 tools/torch_ab.py --tree $t; done

Imports ``torch``, numpy and the package under ``--tree`` only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS = ("basic", "sustained", "preemption", "scan", "wide", "widepods",
        "kernels", "counts", "config")
WIDE_INPUTS = {"A": (30, 5120, 4096, dict(t=100)),
               "B": (31, 1024, 1024, dict(r=4, t=100, sv=64))}
WIDE_PODS = dict(nodes=5000, init=1000, pods=30000, every=64, terms=12)
YARDSTICK = dict(n_nodes=94, n_upcoming=162, n_virtual=256, n_pods=2000,
                 pad=2048)
YARDSTICK_SEED = 10
SCAN_REPEATS = 10
# the ``kernels`` row's slot-route batches past the slot kernel's cache of
# 5,120 columns: (node columns, term references a pod), T = 100
SLOT_SHAPES = ((10240, 1), (10240, 8), (20480, 1), (20480, 8))
# the ``counts`` row's ``random_planes(35, n, b, r=r)`` inputs: (pods,
# node columns, requests a pod)
COUNTS_SHAPES = ((32, 128, 3), (4096, 128, 3), (32, 5120, 3),
                 (4096, 5120, 3), (4096, 5120, 4))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _percentiles(p: dict) -> dict:
    return {k: p[k] for k in ("Perc50", "Perc90", "Perc99") if k in p}


def _time_scan(torch, solver, batch, k=None) -> dict:
    """Ten bare launches (and one before them), each on a fresh copy of
    the state; every result equal. ``k`` forces the columns a thread owns
    (a tree with ``scan_plan``)."""
    static, state, ints, floats = batch
    kernel = solver.scan_kernel
    b = ints.shape[0]
    plan = kernel.plan(static, b, k=k) if hasattr(solver, "scan_plan") \
        else kernel.plan(static)
    params = solver.SolverParams()
    times, outs = [], []
    for _ in range(SCAN_REPEATS + 1):
        st = type(state)(*(t.clone() for t in state))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = kernel.launch(params, static, st, ints, floats, plan)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        outs.append([got.cpu(), *(t.cpu() for t in st)])
    if any(not all(torch.equal(x, y) for x, y in zip(o, outs[0]))
           for o in outs[1:]):
        sys.exit("scan: repeated launches disagree")
    digest = hashlib.sha256(b"".join(
        t.numpy().tobytes() for t in outs[0])).hexdigest()
    r = static.allocatable.shape[1]
    valid = int((ints[:, r + 3] > 0).sum())
    ms = sum(times[1:]) / SCAN_REPEATS
    return {"ms": ms, "ms_each": times[1:],
            "us_per_pod": 1000 * ms / max(valid, 1),
            "pods": valid, "n": static.allocatable.shape[0],
            "placed": int((outs[0][0] >= 0).sum()), "plan": list(plan),
            "digest": digest}


def _time_dense(torch, solve_mod, args, slots=False, wide=False) -> dict:
    """Ten bare launches (and one before them) of the kernel the tree
    plans for ``args`` (planes, state, pod ints, pod floats on the CPU;
    with ``slots``, a slot stream on the slot kernel; with ``wide``, the
    wide kernel forced), each on a fresh copy of the state; every result
    equal."""
    ps, state, ints, floats = args
    moved = type(ps)(ps.ints.cuda(), ps.f32s.cuda(), ps.sc_meta.cuda(),
                     *ps[3:])
    ints, floats = ints.cuda(), floats.cuda()
    kernel = solve_mod.solve_kernel
    kernel.check(moved, state.cuda(), ints, floats, slots=slots)
    plan = kernel.slots_plan(moved) if slots else \
        kernel.wide_plan(moved) if wide else kernel.plan(moved)
    params = solve_mod.SolverParams()
    times, outs = [], []
    for _ in range(SCAN_REPEATS + 1):
        st = state.clone().cuda()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = kernel.launch(params, moved, st, ints, floats, plan)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        outs.append([got.cpu(), st.cpu()])
    if any(not all(torch.equal(x, y) for x, y in zip(o, outs[0]))
           for o in outs[1:]):
        sys.exit("wide: repeated launches disagree")
    digest = hashlib.sha256(b"".join(
        t.numpy().tobytes() for t in outs[0])).hexdigest()
    valid = int((ints[:, ps.r + 3] > 0).sum())
    ms = sum(times[1:]) / SCAN_REPEATS
    return {"ms": ms, "ms_each": times[1:],
            "us_per_pod": 1000 * ms / max(valid, 1), "pods": valid,
            "placed": int((outs[0][0] >= 0).sum()), "plan": list(plan),
            "digest": digest}


def _basic_batch(torch, workloads, nodes=5000, pods=4096, pod_fn=None,
                 offset=0):
    """The SchedulingBasic batch as planes on the CPU: ``pods``
    ``basic_pod``s (or ``pod_fn(offset + i)``) over ``nodes``
    ``node_template`` nodes, none bound."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.ops.encode import BatchEncoder
    from kubernetes_tpu_torch.ops.planes import prepare
    from kubernetes_tpu_torch.ops.solver import pack_podin
    from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot

    pod_fn = pod_fn or workloads.basic_pod
    enc = BatchEncoder(new_snapshot([], [
        Node.from_dict(workloads.node_template(i)) for i in range(nodes)]))
    cluster, batch = enc.encode([Pod.from_dict(pod_fn(offset + i))
                                 for i in range(pods)], pad_pods=pods)
    ps, state = prepare(cluster, batch, "cpu")
    return (ps, state, *(torch.from_numpy(a) for a in pack_podin(batch)))


def _anti_batch(torch, workloads, nodes=5000, init=1000, pods=4096):
    """The first batch of ``chip_smoke.py``'s phase 15 row
    (SchedulingPodAntiAffinity at 5,000 nodes / 1,000 / 30,000): its
    first ``pods`` measured pods, 100 colours, each anti-affine to its
    own (T = 100, one term reference a pod), over ``nodes`` nodes; the
    init pods, which carry no label and request 500m of 32 cpu, left
    out."""
    op = workloads.scheduling_pod_anti_affinity(nodes, init, pods)[3]
    return _basic_batch(torch, workloads, nodes, pods, op["podTemplate"],
                        op["offset"])


def _refs_planes(random_planes, seed, n, b, t, refs):
    """``random_planes(seed, n, b, t=t)`` with every pod referencing
    exactly ``refs`` of the ``t`` terms, drawn with numpy from ``seed``:
    one reference, the pod matched by and anti-affine to it (the
    anti-affinity row's pattern); more, each matched, required or
    anti-affine or weighted at random, as ``random_slot_planes`` draws
    them. The batch packs into slots."""
    ps, state, ints, floats = random_planes(seed, n, b, t=t)
    rng = np.random.default_rng(seed + 15485863)
    c = ps.r + 4 + 2 * ps.sc
    ints[:, c:c + 3 * t] = 0
    floats[:] = 0
    weights = np.array([-5, -3, -1, 1, 2, 4, 7], dtype=np.float32)
    for i in range(b):
        for k in rng.choice(t, refs, replace=False):
            k = int(k)
            if refs == 1:
                ints[i, c + k] = ints[i, c + 2 * t + k] = 1
                continue
            mb, oa = rng.random() < 0.5, rng.random() < 0.1
            oan = rng.random() < 0.15
            ints[i, c + k], ints[i, c + t + k] = int(mb), int(oa)
            ints[i, c + 2 * t + k] = int(oan)
            if rng.random() < 0.6 or not (mb or oa or oan):
                floats[i, k] = float(rng.choice(weights))
    return ps, state, ints, floats


def _time_routed(torch, solve_mod, slot_stream, args) -> dict:
    """``_time_dense`` on the kernel the tree routes a batch of ``args``
    (dense stream) to, by the backend's slot route: the slot kernel on
    the batch's slot stream where the tree plans it for a batch that
    packs, else the tree's plan on the dense stream."""
    ps, state, ints, floats = args
    moved = type(ps)(ps.ints.cuda(), ps.f32s.cuda(), ps.sc_meta.cuda(),
                     *ps[3:])
    if solve_mod.solve_kernel.plan(moved, packs=True).kernel != "slots":
        return _time_dense(torch, solve_mod, args)
    stream = slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc, ps.t)
    return _time_dense(torch, solve_mod, (
        ps, state, *(torch.from_numpy(a) for a in stream)), slots=True)


def _time_sharded(torch, solve_mod, args, shards) -> dict:
    """Ten bare launches (and one before them) of the sharded kernel over
    ``shards`` node shards of ``args`` (single-card planes on the CPU,
    ``shard_planes``), each on fresh copies of the planes and totals;
    every result equal."""
    from kubernetes_tpu_torch.parallel import sharded as sharded_mod

    ps, state, ints, floats = args
    ss, st = sharded_mod.shard_planes(ps, state, shards)
    ss = ss._replace(sc_meta=ss.sc_meta.cuda(), ints=ss.ints.cuda(),
                     f32s=ss.f32s.cuda(), has_dom=ss.has_dom.cuda())
    planes, totals = st.planes.cuda(), st.totals.cuda()
    ints, floats = ints.cuda(), floats.cuda()
    kernel = solve_mod.solve_kernel
    plan = kernel.sharded_plan(ss, shards)
    params = solve_mod.SolverParams()
    times, outs = [], []
    for _ in range(SCAN_REPEATS + 1):
        p, tt = planes.clone(), totals.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got, err = kernel.launch_sharded(params, ss, p, tt, ints, floats,
                                         plan)
        end.record()
        torch.cuda.synchronize()
        if int(err[0]) != 0:
            sys.exit(f"sharded: exchange error {int(err[0])}")
        times.append(start.elapsed_time(end))
        outs.append([got.cpu(), p.cpu(), tt.cpu()])
    if any(not all(torch.equal(x, y) for x, y in zip(o, outs[0]))
           for o in outs[1:]):
        sys.exit("sharded: repeated launches disagree")
    digest = hashlib.sha256(b"".join(
        t.numpy().tobytes() for t in outs[0])).hexdigest()
    valid = int((ints[:, ps.r + 3] > 0).sum())
    ms = sum(times[1:]) / SCAN_REPEATS
    return {"ms": ms, "ms_each": times[1:],
            "us_per_pod": 1000 * ms / max(valid, 1), "pods": valid,
            "placed": int((outs[0][0] >= 0).sum()), "plan": list(plan),
            "digest": digest}


def _time_counts(torch, solve_mod, args, shards=4) -> dict:
    """The feasibility counts kernel over ``shards`` node shards of
    ``args`` (single-card planes on the CPU, ``shard_planes``): ten calls
    of ``launch_counts`` after one, CUDA events around each (with
    ``profiles=False`` on a tree whose wrapper takes it: its bare path),
    every result equal; and the kernel alone, 20 calls of its C entry
    queued behind a sleeping kernel so that the card runs them back to
    back, events around them all."""
    import inspect

    from kubernetes_tpu_torch.parallel import sharded as sharded_mod

    ps, state, ints, _ = args
    ss, _ = sharded_mod.shard_planes(ps, state, shards)
    ss = ss._replace(ints=ss.ints.cuda())
    ints = ints.cuda()
    kernel = solve_mod.solve_kernel
    bare = ({"profiles": False} if "profiles" in inspect.signature(
        kernel.launch_counts).parameters else {})
    times, outs = [], []
    for _ in range(SCAN_REPEATS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = kernel.launch_counts(ss, ints, shards, **bare)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        outs.append(got.cpu())
    if any(not torch.equal(o, outs[0]) for o in outs[1:]):
        sys.exit("counts: repeated launches disagree")
    lib = kernel._load()
    out = torch.zeros_like(ints[:, 0])
    stream = torch.cuda.current_stream().cuda_stream
    n, b = ss.ints.shape[1], ints.shape[0]

    def launch():
        err = lib.ktt_feasible_counts_launch(
            ints.data_ptr(), ss.ints.data_ptr(), out.data_ptr(), ss.r, ss.sc,
            ss.t, ss.u, n, b, ints.shape[1], shards, 1, stream)
        if err != 0:
            sys.exit(f"counts: CUDA error {err}")

    alone = []
    for _ in range(2):
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(20):
            launch()
        end.record()
        torch.cuda.synchronize()
        alone.append(start.elapsed_time(end) / 20)
    return {"wrapper_ms": sum(times[1:]) / SCAN_REPEATS,
            "wrapper_ms_each": times[1:], "alone_ms": alone,
            "digest": hashlib.sha256(outs[0].numpy().tobytes()).hexdigest()}


def _wide_pods_ops(workloads, nodes, init, pods, every, terms,
                   colours=100):
    """The anti-affinity row with every ``every``-th measured pod also
    carrying ``terms`` weighted preferred pod-affinity terms (weights
    1-10) on the next colours over the hostname, in one ``podAffinity``
    block beside the row's ``podAntiAffinity``."""
    ops = workloads.scheduling_pod_anti_affinity(nodes, init, pods)
    template = ops[3]["podTemplate"]

    def pod(i):
        p = template(i)
        if (i - init) % every == 0:
            p["spec"]["affinity"]["podAffinity"] = {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    workloads._affinity(
                        "podAffinity", "color", [f"blue-{(i + x) % colours}"],
                        "kubernetes.io/hostname", weight=1 + (x - 1) % 10)[
                        "affinity"]["podAffinity"][
                        "preferredDuringSchedulingIgnoredDuringExecution"][0]
                    for x in range(1, terms + 1)]}
        return p

    ops[3]["podTemplate"] = pod
    return ops


class _TimedKernel:
    """The solve wrapper with CUDA events around each call."""

    def __init__(self, torch, kernel):
        self.torch, self.kernel, self.events = torch, kernel, []

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    def __call__(self, *args, **kw):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.kernel(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=".",
                    help="the checkout whose package runs")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated, of " + ", ".join(ROWS))
    ap.add_argument("--scan-k", default="",
                    help="scan row: comma-separated columns a thread owns "
                         "to force, each timed (default: the plan's)")
    ap.add_argument("--pin-chunk", action="store_true",
                    help="run_workload(..., adaptive_chunk=False): drains "
                         "and pads at max_batch, on the basic and "
                         "preemption rows (a tree with the tuner)")
    args = ap.parse_args()
    pin = {"adaptive_chunk": False} if args.pin_chunk else {}
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from kubernetes_tpu_torch.harness import perf, sustained, workloads
    from kubernetes_tpu_torch.ops import solve as solve_mod

    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    from kubernetes_tpu_torch.ops import build, solver

    assert solve_mod.__file__.startswith(tree), solve_mod.__file__
    rows = args.rows.split(",")
    t0 = time.monotonic()
    build.build_kernels([solve_mod.KERNEL_SOURCE] * any(
        r != "scan" for r in rows) + [solver.SCAN_SOURCE] * ("scan" in rows))
    out = {"tree": args.tree, "pin_chunk": args.pin_chunk, "card": _card(),
           "build_s": time.monotonic() - t0}
    for row in rows:
        t0 = time.monotonic()
        if row == "basic":
            res = perf.run_workload(
                "SchedulingBasic",
                workloads.make_workload("SchedulingBasic", 5000, 0, 30000),
                max_batch=4096, device="cuda", **pin)
            if len(res.placements) != 30000 or not all(
                    res.placements.values()):
                sys.exit("SchedulingBasic: a pod left unbound")
            out[row] = {"pods_per_s": res.pods_per_second,
                        "duration_s": res.duration_seconds,
                        "enqueue_to_bind_ms": _percentiles(res.latency),
                        "solve_to_bind_ms": _percentiles(res.metrics),
                        "solves": res.solves, "host_seconds": res.seconds,
                        "chunk": getattr(res, "chunk", None)}
        elif row == "sustained":
            got = sustained.run_sustained_row(
                pods=30000, qps=5000.0, seed=14, node_cpu=32,
                max_batch=4096, device="cuda")
            if got["lost_pods"] or got["injected"] != 30000:
                sys.exit(f"sustained: {got['lost_pods']} lost, "
                         f"{got['injected']} injected")
            out[row] = {"pods_per_s": got["value"],
                        "p50_arrival_to_bind_ms":
                            got["p50_arrival_to_bind_ms"],
                        "p99_arrival_to_bind_ms":
                            got["p99_arrival_to_bind_ms"],
                        "rate_normalized":
                            got["rate_normalized_throughput"],
                        "solves": got["session"]["solves"]}
        elif row == "preemption":
            res = perf.run_workload(
                "Preemption", workloads.preemption(5000, 5000, 5000),
                max_batch=4096, device="cuda", seed=11, **pin)
            measured = [f"pod-{5000 + i}" for i in range(5000)]
            if not all(res.placements.get(n) for n in measured):
                sys.exit("Preemption: a measured pod left unbound")
            out[row] = {"pods_per_s": res.pods_per_second,
                        "duration_s": res.duration_seconds,
                        "enqueue_to_bind_ms": _percentiles(res.latency),
                        "victims": res.victims, "solves": res.solves,
                        "host_paths": res.host_paths,
                        "chunk": getattr(res, "chunk", None)}
        elif row == "scan":
            from kubernetes_tpu_torch.harness.problems import (
                autoscale_whatif,
                whatif_problem,
            )

            def scan_inputs(cluster, batch, pen, dis):
                scores, valid = solver.whatif_overrides(cluster, batch, pen,
                                                        dis)
                return solver.scan_inputs(cluster, batch, "cuda", scores,
                                          valid)

            inputs = {"yardstick": scan_inputs(*whatif_problem(
                YARDSTICK_SEED, **YARDSTICK)),
                "autoscale_whatif": scan_inputs(*autoscale_whatif())}
            out[row] = {name: _time_scan(torch, solver, x)
                        for name, x in inputs.items()}
            for k in filter(None, args.scan_k.split(",")):
                out[row][f"k={k}"] = {
                    name: _time_scan(torch, solver, x, k=int(k))
                    for name, x in inputs.items()}
        elif row == "wide":
            from kubernetes_tpu_torch.harness.problems import random_planes
            out[row] = {}
            for name, (seed, n, b, kw) in WIDE_INPUTS.items():
                ps, state, ints, floats = random_planes(seed, n, b, **kw)
                if name == "A":
                    c = ps.r + 4 + 2 * ps.sc
                    ints[3, c:c + 3 * ps.t] = 0
                    floats[3] = 0
                    ints[3, c:c + 9] = 1
                out[row][name] = _time_dense(torch, solve_mod,
                                             (ps, state, ints, floats))
        elif row == "config":
            from kubernetes_tpu_torch.harness import ha
            got = ha.config_row(5000, 30000, every=200, device="cuda",
                                max_batch=4096)
            res = got["result"]
            if got["unbound"]:
                sys.exit(f"config: {len(got['unbound'])} pods unbound")
            out[row] = {"pods_per_s": res.pods_per_second,
                        "duration_s": res.duration_seconds,
                        "enqueue_to_bind_ms": _percentiles(res.latency),
                        "serial_seconds": got["serial_seconds"],
                        "solves": res.solves, "host_seconds": res.seconds}
        elif row == "kernels":
            from kubernetes_tpu_torch.harness.problems import (
                random_planes,
                random_slot_planes,
            )
            from kubernetes_tpu_torch.ops.slots import slot_stream
            ps, state, ints, floats = random_slot_planes(33, 5120, 4096, 100)
            stream = slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc,
                                 ps.t)
            basic = _basic_batch(torch, workloads)
            out[row] = {
                "cluster": _time_dense(torch, solve_mod,
                                       random_planes(32, 5120, 4096)),
                "slots": _time_dense(torch, solve_mod, (
                    ps, state, *(torch.from_numpy(a) for a in stream)),
                    slots=True),
                "slots_wide": _time_dense(torch, solve_mod,
                                          (ps, state, ints, floats),
                                          wide=True),
                "basic_cluster": _time_dense(torch, solve_mod, basic),
                "basic_wide": _time_dense(torch, solve_mod, basic,
                                          wide=True)}
            for s in (1, 2, 4):
                out[row][f"sharded_{s}"] = _time_sharded(torch, solve_mod,
                                                         basic, s)
            out[row]["counts_4"] = _time_counts(torch, solve_mod, basic)
            out[row]["anti"] = _time_routed(torch, solve_mod, slot_stream,
                                            _anti_batch(torch, workloads))
            for n, refs in SLOT_SHAPES:
                out[row][f"refs_{n}_{refs}"] = _time_routed(
                    torch, solve_mod, slot_stream, _refs_planes(
                        random_planes, 34, n, 4096, 100, refs))
        elif row == "counts":
            from kubernetes_tpu_torch.harness.problems import random_planes
            out[row] = {"basic_4": _time_counts(
                torch, solve_mod, _basic_batch(torch, workloads))}
            for b, n, r in COUNTS_SHAPES:
                out[row][f"b{b}_n{n}_r{r}"] = _time_counts(
                    torch, solve_mod, random_planes(35, n, b, r=r), shards=1)
        elif row == "widepods":
            w = WIDE_PODS
            real = solve_mod.solve_kernel
            timed = _TimedKernel(torch, real)
            real.reset_counts()
            solve_mod.solve_kernel = timed
            try:
                res = perf.run_workload(
                    "SchedulingPodAntiAffinity",
                    _wide_pods_ops(workloads, w["nodes"], w["init"],
                                   w["pods"], w["every"], w["terms"]),
                    max_batch=4096, device="cuda")
            finally:
                solve_mod.solve_kernel = real
            torch.cuda.synchronize()
            measured = [f"pod-{w['init'] + i}" for i in range(w["pods"])]
            if not all(res.placements.get(n) for n in measured):
                sys.exit("widepods: a measured pod left unbound")
            out[row] = {"pods_per_s": res.pods_per_second,
                        "duration_s": res.duration_seconds,
                        "enqueue_to_bind_ms": _percentiles(res.latency),
                        "solves": res.solves, "launches": dict(real.counts),
                        "kernel_ms": [s.elapsed_time(e)
                                      for s, e in timed.events]}
        else:
            sys.exit(f"unknown row {row!r}")
        out[row]["wall_s"] = time.monotonic() - t0
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
