"""The batch solve over the planes layout: its plain PyTorch version, the
wrapper of the hand-written CUDA kernels (``csrc/solve_kernel.cu``), their
launch plan, and the solve backend the session drives.

``solve`` takes the plain version for CPU tensors and launches a kernel
for CUDA tensors; it never falls back from one to the other. Both update
the state planes in place (the state carried to the next batch) and
return the assignment of each pod row, -1 where no node is feasible or
the row is padding.

Three kernels run on the card, and ``plan_launch`` picks one for each
batch: the cluster kernel (the node axis over a thread-block cluster,
each block's slice of the planes in its shared memory) whenever that
layout fits one block's shared memory; else, when every pod of the batch
references at most ``SPARSE_K`` terms, the slot kernel (the same cluster
design over the slot stream of ``ops/slots.py``, the term rows in global
memory); else the one-block kernel (planes in global memory). The
backend packs the slot stream (``solve_slots``) only for batches of at
least ``SPARSE_MIN_T`` terms that the cluster kernel does not take, as
the reference routes its sparse scan. An epoch with shared-volume slots
(``PStatic.sv > 0``) never takes the slot kernel, as the reference's
sparse scan has no attach planes: the cluster and one-block kernels and
the plain version carry them.

Float scores are computed in the same order, with the same f32
operations, as the reference solve, so assignments agree exactly:
``score = bw*balanced + lw*least + sw*spread + aw*pref + stw*static``
summed left to right, ``pref`` accumulated over terms from 0 and the
soft-spread counts over constraints.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops.planes import (
    PStatic,
    prepare,
    state_planes,
    static_planes,
)
from kubernetes_tpu_torch.ops.slots import (
    SPARSE_K,
    SPARSE_MIN_T,
    slot_refs,
    slot_stream,
    slot_width,
)
from kubernetes_tpu_torch.ops.solver import BIG, NEG_INF, SolverParams
from kubernetes_tpu_torch.observability.devprof import get_devprof

PACKAGE_DIR = Path(__file__).resolve().parent.parent
KERNEL_SOURCE = PACKAGE_DIR / "csrc" / "solve_kernel.cu"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# one block's shared memory on Hopper (227 KB), the block sizes and the
# pod chunk the kernels are written for (csrc/solve_kernel.cu)
SMEM_LIMIT = 232448
CLUSTER_THREADS = 512
BLOCK_THREADS = 1024
POD_CHUNK = 32
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8


class LaunchPlan(NamedTuple):
    """How a solve launches: which kernel, its cluster size, threads per
    block, node columns per block and shared-memory bytes per block."""

    kernel: str             # "cluster", "slots" or "block"
    cluster: int
    threads: int
    cols_per_block: int
    smem_bytes: int
    chunk: int              # pod rows staged at a time (cluster kernels)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pod_width(r: int, sc: int, t: int, sv: int = 0) -> int:
    """Int columns of a dense pod-stream row (``pack_podin``)."""
    return r + 4 + 2 * sc + 3 * t + (2 if sv else 0)


def cluster_smem_bytes(r: int, sc: int, t: int, u: int, cluster: int,
                       threads: int, cols_per_block: int, chunk: int,
                       sv: int = 0) -> int:
    """Shared memory of one block of the cluster kernel, as its layout
    (``cluster_layout`` in the source) lays it out: the block's slice of
    every state row but the shared-volume rows (left in global memory)
    and totals, and of the static rows each pod reads (alloc, max_pods,
    node_valid, the codes, the U masks and static scores), a score row,
    the totals, ``sc_meta``, two pod chunks, the pods' fact lists, the
    block reduction's warp slots and the cluster exchange's slots (two
    parities). Shared-volume slots add only the two pod columns."""
    width = pod_width(r, sc, t, sv)
    rows = (r + 3 + sc + 2 * t) + (r + 2 + sc + t + 2 * u) + 1
    words = (rows * cols_per_block + t + 2 * sc
             + 2 * chunk * (width + t) + chunk * (8 + 3 * sc + 4 * t)
             + (sc + 2) * (threads // 32) + 2 * cluster * (sc + 2))
    return 4 * words


def slots_smem_bytes(r: int, sc: int, t: int, u: int, cluster: int,
                     threads: int, cols_per_block: int, chunk: int) -> int:
    """Shared memory of one block of the slot kernel, as its layout
    (``slots_layout`` in the source) lays it out: the cluster kernel's
    without the term rows (they stay in global memory) and with slot-
    stream pod chunks (``R+4+2*SC+2*K`` ints and ``K`` weights a pod) and
    slot fact lists. Only the totals grow with T, one word a term."""
    rows = (r + 3 + sc) + (r + 2 + sc + 2 * u) + 1
    words = (rows * cols_per_block + t + 2 * sc
             + 2 * chunk * (slot_width(r, sc) + SPARSE_K)
             + chunk * (8 + 3 * sc + 3 * SPARSE_K)
             + (sc + 2) * (threads // 32) + 2 * cluster * (sc + 2))
    return 4 * words


def block_plan(n: int, sc: int, t: int) -> LaunchPlan:
    """The one-block kernel's launch: up to 1024 threads over all N
    columns, shared memory for the reductions and the totals only."""
    return LaunchPlan("block", 1, min(_round_up(n, 32), BLOCK_THREADS), n,
                      4 * (3 * (BLOCK_THREADS // 32 + 1) + sc + t), 0)


def cluster_candidate(n: int, r: int, sc: int, t: int, u: int,
                      max_cluster: int = MAX_CLUSTER, sv: int = 0
                      ) -> LaunchPlan:
    """The cluster kernel's launch over ``n`` node columns, whether or not
    it fits: the node axis cut into ``max_cluster`` slices of a multiple
    of 32 columns (the last one ragged), one block each, at most 512
    threads a block."""
    cols = _round_up(-(-n // max_cluster), 32)
    cluster = -(-n // cols)
    threads = min(cols, CLUSTER_THREADS)
    smem = cluster_smem_bytes(r, sc, t, u, cluster, threads, cols, POD_CHUNK,
                              sv)
    return LaunchPlan("cluster", cluster, threads, cols, smem, POD_CHUNK)


def slots_candidate(n: int, r: int, sc: int, t: int, u: int,
                    max_cluster: int = MAX_CLUSTER) -> LaunchPlan:
    """The slot kernel's launch over ``n`` node columns, whether or not
    it fits: the cluster kernel's cut of the node axis."""
    c = cluster_candidate(n, r, sc, t, u, max_cluster)
    smem = slots_smem_bytes(r, sc, t, u, c.cluster, c.threads,
                            c.cols_per_block, c.chunk)
    return c._replace(kernel="slots", smem_bytes=smem)


def plan_launch(n: int, r: int, sc: int, t: int, u: int,
                max_cluster: int = MAX_CLUSTER, packs: bool = False,
                sv: int = 0) -> LaunchPlan:
    """The launch of a solve over ``n`` node columns, the first that fits
    one block's shared memory (227 KB): the cluster kernel
    (``cluster_candidate``); the slot kernel (``slots_candidate``) when
    the batch ``packs`` into slots and has no shared-volume slots
    (``sv``); the one-block kernel."""
    plan = cluster_candidate(n, r, sc, t, u, max_cluster, sv)
    if plan.smem_bytes <= SMEM_LIMIT:
        return plan
    if packs and not sv:
        plan = slots_candidate(n, r, sc, t, u, max_cluster)
        if plan.smem_bytes <= SMEM_LIMIT:
            return plan
    return block_plan(n, sc, t)


def _pod_columns(r: int, sc: int, t: int) -> dict:
    """Column offsets of the packed pod stream (``pack_podin``); ``sv``
    holds the slot, ``sv + 1`` the attach column, in an epoch with
    shared-volume slots."""
    return {
        "req": 0, "nonzero": r, "profile": r + 2, "valid": r + 3,
        "pod_sc": r + 4, "sc_match": r + 4 + sc,
        "match_by": r + 4 + 2 * sc, "own_aff": r + 4 + 2 * sc + t,
        "own_anti": r + 4 + 2 * sc + 2 * t, "sv": r + 4 + 2 * sc + 3 * t,
    }


def solve_plain(params: SolverParams, ps: PStatic, state: torch.Tensor,
                pod_ints: torch.Tensor, pod_floats: torch.Tensor
                ) -> torch.Tensor:
    """The solve as a per-pod loop of tensor operations, on any device.
    Per-pod flags are read on the host, so terms and constraints a pod
    does not use are skipped (adding zero changes nothing)."""
    r, scn, tn = ps.r, ps.sc, ps.t
    c = _pod_columns(r, scn, tn)
    mb, oa, oan = c["match_by"], c["own_aff"], c["own_anti"]
    pods = []
    for row, wrow in zip(pod_ints.tolist(), pod_floats.tolist()):
        pods.append((row, [
            (k, row[mb + k], row[oa + k], row[oan + k], wrow[k])
            for k in range(tn)
            if row[mb + k] or row[oa + k] or row[oan + k] or wrow[k] != 0.0]))
    return _solve_pods(params, ps, state, pods)


def solve_plain_slots(params: SolverParams, ps: PStatic, state: torch.Tensor,
                      slot_ints: torch.Tensor, slot_floats: torch.Tensor
                      ) -> torch.Tensor:
    """``solve_plain`` over the slot stream (``ops/slots.py``): each pod's
    terms are its active slots, in term order. The same function as
    ``solve_plain`` on the dense stream the slots were packed from, and
    as the reference's sparse scan (``_xla_planes_solve_sparse``), whose
    sum over all K slots adds only +0.0 for inactive ones. Planes with
    shared-volume slots are refused, as by the slot kernel."""
    check_no_sv(ps)
    pods = [(row, slot_refs(row, wrow, ps.r, ps.sc))
            for row, wrow in zip(slot_ints.tolist(), slot_floats.tolist())]
    return _solve_pods(params, ps, state, pods)


def _solve_pods(params: SolverParams, ps: PStatic, state: torch.Tensor,
                pods: list) -> torch.Tensor:
    """The per-pod loop of ``solve_plain``: ``pods`` holds each pod's
    row (the pod stream's columns; the slot stream's base columns) and
    its term references (term, matched, own affinity, own anti-affinity,
    weight) in term order.

    Shared volumes (``ps.sv > 0``): a pod whose slot is below SV needs
    one more attachment of its attach column on every node where the
    slot's volume is not attached yet, and the winner's column counts it
    and marks the volume attached there."""
    r, scn, tn, v, svn = ps.r, ps.sc, ps.t, ps.v, ps.sv
    so, _ = static_planes(r, scn, tn, ps.u)
    do, _ = state_planes(r, scn, tn, svn)
    c = _pod_columns(r, scn, tn)
    ints, dev = ps.ints, ps.ints.device
    n = ints.shape[1]
    bw, lw, sw, aw, stw = params.as_tuple()

    node_valid = ints[so["node_valid"]] > 0
    max_pods = ints[so["max_pods"]]
    alloc = ints[so["alloc"]:so["alloc"] + r]
    alloc_cpu = torch.clamp(alloc[0], min=1).to(torch.float32)
    alloc_mem = torch.clamp(alloc[1], min=1).to(torch.float32)
    sc_codes = ints[so["sc_codes"]:so["sc_codes"] + scn]
    term_codes = ints[so["term_codes"]:so["term_codes"] + tn]
    t_real = term_codes < v
    flat_idx = torch.arange(n, dtype=torch.int32, device=dev)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=dev)
    max_skew = ps.sc_meta[0].tolist()
    hard = (ps.sc_meta[1] > 0).tolist()
    totals = state[do["totals"], :tn].tolist()
    out = []
    for row, refs in pods:
        if row[c["valid"]] <= 0:
            out.append(-1)
            continue
        profile = row[c["profile"]]
        # ---- feasibility
        feasible = node_valid & (state[do["pod_count"]] < max_pods)
        for ri in range(r):
            feasible &= state[do["requested"] + ri] + row[ri] <= alloc[ri]
        feasible &= ints[so["masks"] + profile] > 0
        slot = row[c["sv"]] if svn else svn
        if slot < svn:
            col = row[c["sv"] + 1]
            demand = 1 - state[do["sv_attached"] + slot]
            feasible &= (state[do["requested"] + col] + row[col] + demand
                         <= alloc[col])
        for sci in range(scn):
            if row[c["pod_sc"] + sci] > 0 and hard[sci]:
                counts = state[do["sc_counts"] + sci]
                dom = ints[so["sc_domain"] + profile * scn + sci] > 0
                min_c = int(torch.where(dom, counts, BIG).min()) \
                    if bool(dom.any()) else 0
                skew = counts + row[c["sc_match"] + sci] - min_c
                feasible &= (sc_codes[sci] < v) & (skew <= max_skew[sci])
        has_aff, no_any, self_all = False, True, True
        for ti, matched, aff, anti, _ in refs:
            if matched > 0:
                feasible &= state[do["term_owners"] + ti] <= 0
            if anti > 0:
                feasible &= state[do["term_counts"] + ti] <= 0
            if aff > 0:
                has_aff = True
                no_any &= totals[ti] == 0
                self_all &= matched > 0
        if has_aff and not (no_any and self_all):
            for ti, _, aff, _, _ in refs:
                if aff > 0:
                    feasible &= (state[do["term_counts"] + ti] > 0) \
                        & t_real[ti]
        # ---- scores
        cpu_frac = (state[do["nonzero"]] + row[c["nonzero"]]).to(
            torch.float32) / alloc_cpu
        mem_frac = (state[do["nonzero"] + 1] + row[c["nonzero"] + 1]).to(
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
                soft_counts += state[do["sc_counts"] + sci].to(torch.float32)
                any_soft = True
        if any_soft:
            # a tensor numerator: Python's ``100.0 / t`` is a reciprocal
            # times 100 in PyTorch, not one IEEE division
            spread = torch.div(hundred, 1.0 + soft_counts)
        else:
            spread = torch.zeros(n, dtype=torch.float32, device=dev)
        pref = torch.zeros(n, dtype=torch.float32, device=dev)
        for ti, _, _, _, w in refs:
            if w != 0.0:
                pref += w * state[do["term_counts"] + ti].to(torch.float32)
        score = (bw * balanced + lw * least + sw * spread + aw * pref
                 + stw * ps.f32s[profile])
        score = torch.where(feasible, score, NEG_INF)
        # ---- best node, lowest index on ties
        mx = score.max()
        if not bool(mx > NEG_INF / 2):
            out.append(-1)
            continue
        chosen = int(torch.where(feasible & (score >= mx), flat_idx,
                                 BIG).min())
        out.append(chosen)
        # ---- commit
        for ri in range(r):
            state[do["requested"] + ri, chosen] += row[ri]
        state[do["nonzero"], chosen] += row[c["nonzero"]]
        state[do["nonzero"] + 1, chosen] += row[c["nonzero"] + 1]
        state[do["pod_count"], chosen] += 1
        if slot < svn:
            state[do["requested"] + col, chosen] += demand[chosen]
            state[do["sv_attached"] + slot, chosen] = 1
        for sci in range(scn):
            inc = row[c["sc_match"] + sci]
            if inc:
                same = sc_codes[sci] == sc_codes[sci, chosen]
                state[do["sc_counts"] + sci] += same.to(torch.int32) * inc
        for ti, matched, _, anti, _ in refs:
            if not (matched or anti):
                continue
            code_j = int(term_codes[ti, chosen])
            same = (term_codes[ti] == code_j).to(torch.int32)
            state[do["term_counts"] + ti] += same * matched
            state[do["term_owners"] + ti] += same * anti
            if code_j < v:
                totals[ti] += matched
    state[do["totals"]] = 0
    state[do["totals"], :tn] = torch.tensor(totals, dtype=torch.int32,
                                            device=dev)
    return torch.tensor(out, dtype=torch.int32, device=dev)


# ----------------------------------------------------------------------
def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the solve kernel is built from "
                           f"{KERNEL_SOURCE} with the CUDA toolkit")
    return path


def build_kernel() -> Path:
    """Compile ``csrc/solve_kernel.cu`` for sm_90a into a shared library
    under ``build/``, named by the hash of the source and flags, so an
    edited source rebuilds; ptxas's report (registers, shared memory and
    spills of each kernel) is kept beside it. Returns the library's path."""
    src = KERNEL_SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libsolve_kernel_{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {KERNEL_SOURCE}:\n{proc.stderr}")
    ptxas_report_path(lib).write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_report_path(lib: Path) -> Path:
    """Where ``build_kernel`` keeps ptxas's report for ``lib``."""
    return lib.with_suffix(".ptxas.txt")


class SolveKernel:
    """ctypes binding of the CUDA solve kernels. ``counts`` holds the
    launches this wrapper made of each kernel ("cluster", "slots",
    "block"); ``launches`` is their sum. The library is built and loaded
    on the first launch.

    Compiles: the library's build and load, and the first launch of each
    kernel instance (a kernel with shared-volume planes or without; under
    lazy module loading that launch loads the module), are timed on the
    host where they happen and reported to the device profiler
    (``note_compile``), which books them to the solve cycle open on this
    thread. ``compiles`` lists them: (what, seconds)."""

    def __init__(self):
        self.counts = {"cluster": 0, "slots": 0, "block": 0}
        self._lib = None
        self._lock = threading.Lock()
        self._plans = {}
        self.launched = set()   # (kernel, with sv) instances launched
        self.compiles = []

    def note_compile(self, what: str, seconds: float) -> None:
        """A build and load or a first launch (``what``) took
        ``seconds``."""
        self.compiles.append((what, seconds))
        get_devprof().on_compile(seconds)

    @property
    def launches(self) -> int:
        return sum(self.counts.values())

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    def _load(self):
        with self._lock:
            if self._lib is None:
                t0 = time.monotonic()
                lib = ctypes.CDLL(str(build_kernel()))
                p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                for name in ("cluster", "slots"):
                    getattr(lib, f"ktt_solve_{name}_launch").argtypes = (
                        [p] * 7 + [i] * 13 + [f] * 5 + [p])
                    getattr(lib, f"ktt_{name}_max_active").argtypes = [i] * 3
                    getattr(lib, f"ktt_{name}_smem_bytes").argtypes = [i] * 9
                lib.ktt_solve_block_launch.argtypes = (
                    [p] * 7 + [i] * 10 + [f] * 5 + [p])
                for name in ("ktt_solve_cluster_launch",
                             "ktt_solve_slots_launch",
                             "ktt_solve_block_launch",
                             "ktt_cluster_max_active", "ktt_slots_max_active",
                             "ktt_cluster_smem_bytes",
                             "ktt_slots_smem_bytes"):
                    getattr(lib, name).restype = ctypes.c_int
                self._lib = lib
                self.note_compile("load", time.monotonic() - t0)
        return self._lib

    def check(self, ps: PStatic, state: torch.Tensor, pod_ints: torch.Tensor,
              pod_floats: torch.Tensor, profiles: bool = True,
              slots: bool = False) -> None:
        """Raise ValueError on inputs the kernels do not take: the dense
        pod stream, or with ``slots`` the slot stream (never with
        shared-volume slots). With ``profiles`` False the caller has
        checked the pods' profile indices and volume references on the
        host (``check_profiles``, ``check_sv``; a stream from
        ``slot_stream`` has its slot indices in range), and nothing here
        waits on the card."""
        r, sc, t, u, sv = ps.r, ps.sc, ps.t, ps.u, ps.sv
        n = ps.ints.shape[1]
        b = pod_ints.shape[0]
        if slots:
            check_no_sv(ps)
            width, fwidth = slot_width(r, sc), SPARSE_K
        else:
            width, fwidth = pod_width(r, sc, t, sv), t
        expected = (
            (ps.ints, torch.int32, (static_planes(r, sc, t, u)[1], n)),
            (ps.f32s, torch.float32, (u, n)),
            (ps.sc_meta, torch.int32, (2, sc)),
            (state, torch.int32, (state_planes(r, sc, t, sv)[1], n)),
            (pod_ints, torch.int32, (b, width)),
            (pod_floats, torch.float32, (b, fwidth)),
        )
        device = state.device
        for tensor, dtype, shape in expected:
            if tensor.device != device or tensor.dtype != dtype \
                    or tuple(tensor.shape) != shape \
                    or not tensor.is_contiguous():
                raise ValueError(
                    f"solve kernel wants a contiguous {dtype} {shape} on "
                    f"{device}; got {tensor.dtype} {tuple(tensor.shape)} on "
                    f"{tensor.device}")
        if n % 128 != 0 or t > n:
            raise ValueError(f"bad plane width {n} for {t} terms")
        if profiles:
            # reads the pod rows: on the card, a wait for the stream
            check_profiles(pod_ints[:, r + 2], u)
            if slots:
                check_slots(pod_ints, r, sc, t)
            else:
                check_sv(pod_ints, r, sc, t, sv)

    def plan(self, ps: PStatic, packs: bool = False) -> LaunchPlan:
        """``plan_launch`` for these planes on this card: a cluster of 16
        where the card can hold one of that shape, else 8 (the portable
        size). The shared-memory size is checked against the source's own
        layout."""
        key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u)
        if (key, packs, ps.sv) not in self._plans:
            self._plans[key, packs, ps.sv] = self._fitted(
                lambda size: plan_launch(*key, max_cluster=size, packs=packs,
                                         sv=ps.sv), ps)
        return self._plans[key, packs, ps.sv]

    def slots_plan(self, ps: PStatic) -> LaunchPlan:
        """The slot kernel's own launch for these planes on this card
        (``slots_candidate``, 16 blocks or the portable 8), whatever
        ``plan_launch`` would pick: the kernel a slot stream runs on."""
        check_no_sv(ps)
        key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u)
        if (key, "slots") not in self._plans:
            self._plans[key, "slots"] = self._fitted(
                lambda size: slots_candidate(*key, max_cluster=size), ps)
        return self._plans[key, "slots"]

    def _fitted(self, make, ps: PStatic) -> LaunchPlan:
        """``make(16)``, or ``make(8)`` where the card holds no cluster of
        the first's shape."""
        lib = self._load()
        plan = make(MAX_CLUSTER)
        if plan.kernel != "block" and self._active(lib, plan, ps) < 1:
            plan = make(PORTABLE_CLUSTER)
        if plan.kernel != "block" and self._active(lib, plan, ps) < 1:
            raise RuntimeError(f"the card holds no cluster of {plan}")
        return plan

    @staticmethod
    def _active(lib, plan: LaunchPlan, ps: PStatic) -> int:
        """Clusters of ``plan``'s shape the card holds at once."""
        want = getattr(lib, f"ktt_{plan.kernel}_smem_bytes")(
            ps.r, ps.sc, ps.t, ps.u, ps.sv, plan.cluster, plan.threads,
            plan.cols_per_block, plan.chunk)
        if want != plan.smem_bytes:
            raise RuntimeError(f"launch plan's shared memory {plan.smem_bytes}"
                               f" B differs from the kernel's layout, {want} B")
        active = getattr(lib, f"ktt_{plan.kernel}_max_active")(
            plan.cluster, plan.threads, plan.smem_bytes)
        if active < 0:
            raise RuntimeError(f"cluster occupancy query failed: CUDA error "
                               f"{-active}")
        return active

    def launch(self, params: SolverParams, ps: PStatic, state: torch.Tensor,
               pod_ints: torch.Tensor, pod_floats: torch.Tensor,
               plan: LaunchPlan) -> torch.Tensor:
        """Launch the kernel ``plan`` names on checked inputs (``check``:
        the slot stream for the slot kernel, the dense stream for the
        others), on the current stream, without synchronising."""
        lib = self._load()
        instance = (plan.kernel, ps.sv > 0)
        first = instance not in self.launched
        t0 = time.monotonic()
        n, b = ps.ints.shape[1], pod_ints.shape[0]
        assign = torch.empty(b, dtype=torch.int32, device=state.device)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        ptrs = (ps.sc_meta.data_ptr(), pod_ints.data_ptr(),
                pod_floats.data_ptr(), ps.ints.data_ptr(), ps.f32s.data_ptr(),
                state.data_ptr(), assign.data_ptr())
        dims = (ps.r, ps.sc, ps.t, ps.u, ps.v, ps.sv, n, b)
        if plan.kernel == "block":
            err = lib.ktt_solve_block_launch(
                *ptrs, *dims, plan.threads, plan.smem_bytes,
                *params.as_tuple(), stream)
        else:
            err = getattr(lib, f"ktt_solve_{plan.kernel}_launch")(
                *ptrs, *dims, plan.cluster, plan.threads, plan.cols_per_block,
                plan.chunk, plan.smem_bytes, *params.as_tuple(), stream)
        if err != 0:
            raise RuntimeError(f"solve {plan.kernel} kernel launch failed: "
                               f"CUDA error {err}")
        self.counts[plan.kernel] += 1
        if first:
            self.launched.add(instance)
            self.note_compile(f"first launch {plan.kernel}"
                              + (" sv" if instance[1] else ""),
                              time.monotonic() - t0)
        return assign

    def __call__(self, params: SolverParams, ps: PStatic,
                 state: torch.Tensor, pod_ints: torch.Tensor,
                 pod_floats: torch.Tensor, profiles_checked: bool = False,
                 slots: bool = False) -> torch.Tensor:
        """Check and launch: a dense stream on the kernel ``plan`` picks,
        a slot stream (``slots``) on the slot kernel (which raises for
        planes with shared-volume slots)."""
        self.check(ps, state, pod_ints, pod_floats,
                   profiles=not profiles_checked, slots=slots)
        plan = self.slots_plan(ps) if slots else self.plan(ps)
        return self.launch(params, ps, state, pod_ints, pod_floats, plan)


solve_kernel = SolveKernel()


def check_profiles(profiles, u: int) -> None:
    """Raise ValueError when a pod's profile index is outside [0, u)."""
    if bool(((profiles < 0) | (profiles >= u)).any()):
        raise ValueError(f"pod profile index outside [0, {u})")


def check_no_sv(ps: PStatic) -> None:
    """Raise ValueError for planes with shared-volume slots: the slot
    stream carries no attach-plane references."""
    if ps.sv:
        raise ValueError(f"the slot solve has no shared-volume planes; "
                         f"these planes have {ps.sv} slots")


def check_sv(pod_ints, r: int, sc: int, t: int, sv: int) -> None:
    """Raise ValueError when a pod's shared-volume slot is outside
    [0, sv] (sv: none) or its attach column outside [0, r)."""
    if not sv:
        return
    c = r + 4 + 2 * sc + 3 * t
    slot, col = pod_ints[:, c], pod_ints[:, c + 1]
    if bool(((slot < 0) | (slot > sv) | (col < 0) | (col >= r)).any()):
        raise ValueError(f"shared-volume slot outside [0, {sv}] or attach "
                         f"column outside [0, {r})")


def check_slots(slot_ints, r: int, sc: int, t: int) -> None:
    """Raise ValueError when a slot's term index is outside [0, t)."""
    c = r + 4 + 2 * sc
    idx = slot_ints[:, c:c + SPARSE_K]
    if bool(((idx < 0) | (idx >= t)).any()):
        raise ValueError(f"slot term index outside [0, {t})")


def solve(params: SolverParams, ps: PStatic, state: torch.Tensor,
          pod_ints: torch.Tensor, pod_floats: torch.Tensor,
          profiles_checked: bool = False) -> torch.Tensor:
    """Solve one batch: the plain version on CPU tensors, the CUDA kernel
    on CUDA tensors."""
    if state.device.type == "cpu":
        return solve_plain(params, ps, state, pod_ints, pod_floats)
    if state.device.type == "cuda":
        return solve_kernel(params, ps, state, pod_ints, pod_floats,
                            profiles_checked=profiles_checked)
    raise ValueError(f"no solve for device {state.device}")


def solve_slots(params: SolverParams, ps: PStatic, state: torch.Tensor,
                slot_ints: torch.Tensor, slot_floats: torch.Tensor,
                profiles_checked: bool = False) -> torch.Tensor:
    """Solve one batch given as its slot stream: the plain version on
    CPU tensors, the slot kernel on CUDA tensors."""
    if state.device.type == "cpu":
        return solve_plain_slots(params, ps, state, slot_ints, slot_floats)
    if state.device.type == "cuda":
        return solve_kernel(params, ps, state, slot_ints, slot_floats,
                            profiles_checked=profiles_checked, slots=True)
    raise ValueError(f"no solve for device {state.device}")


def plan_batch(ps: PStatic, packs: bool = False) -> LaunchPlan:
    """The launch plan of a batch on these planes: the card's
    (``SolveKernel.plan``) for planes on the card, ``plan_launch``'s for
    planes on the CPU, whose plain versions route alike."""
    if ps.ints.device.type == "cuda":
        return solve_kernel.plan(ps, packs)
    return plan_launch(ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u,
                       packs=packs, sv=ps.sv)


class SolveHandle(NamedTuple):
    """A dispatched solve: the assignments on the device, the host buffer
    a copy fills, the event recorded after that copy (None on the CPU),
    the host clock at the end of the dispatch, and the timing events
    recorded just before and just after the launch (None on the CPU)."""

    assign: torch.Tensor
    host: torch.Tensor
    event: object
    dispatched_at: float
    started: object = None
    ended: object = None


# a staging slot holds at least this many bytes: the pod stream of a
# 4,096-pod batch up to 64 columns, so a smaller pad, another term count
# or another scatter length allocates nothing
MIN_STAGING_BYTES = 1 << 20
# slots of each capacity: the takes of the solves in flight at once (two,
# in the pipelined loop; a cycle takes three for its solve and two for
# each catch-up scatter) and room
STAGING_DEPTH = 16


class PinnedRing:
    """Pinned host buffers by capacity (a power of two, at least
    ``MIN_STAGING_BYTES``), reused round-robin, so a dispatch allocates no
    pinned memory (an allocation can wait for the card). A take is a view
    of a slot's buffer at the shape and dtype asked for. Readbacks have
    rings of their own: their buffers are read on the host after their
    event, when the batch is materialized. A slot is refilled
    only after the event of its last use has fired; it has, unless more
    than ``depth - 1`` takes of its capacity are still in flight, and then
    the refill waits for it (``waits`` counts those).

    One ring serves the process (``STAGING``), as a compiled program
    serves every session: a capacity's first use allocates its buffers,
    timed and reported to the device profiler as a compile
    (``on_compile``), so one inside a measured cycle is an unexpected
    compile; ``allocations`` lists them: (capacity bytes, seconds)."""

    def __init__(self, depth: int = STAGING_DEPTH):
        self.depth = depth
        self.waits = 0
        self.allocations = []
        self._rings = {}   # (capacity, readback) -> [slots, next index]
        self._lock = threading.Lock()

    def take(self, shape, dtype, readback: bool = False
             ) -> Tuple[torch.Tensor, list]:
        """A view of a slot's buffer as ``shape`` and ``dtype``, and the
        slot, ``[pinned buffer, event of its last use or None]``, whose
        buffer nothing in flight still reads; the caller marks its own use
        (``CudaPlanesBackend._fence``)."""
        shape = tuple(shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        cap = max(MIN_STAGING_BYTES, 1 << max(nbytes - 1, 0).bit_length())
        key = (cap, readback)
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                t0 = time.monotonic()
                ring = self._rings[key] = [[
                    [torch.empty(cap, dtype=torch.uint8, pin_memory=True),
                     None] for _ in range(self.depth)], 0]
                seconds = time.monotonic() - t0
                self.allocations.append((cap, seconds))
                get_devprof().on_compile(seconds)
            slots, i = ring
            ring[1] = (i + 1) % self.depth
        slot = slots[i]
        if slot[1] is not None and not slot[1].query():
            self.waits += 1
            slot[1].synchronize()
        return slot[0][:nbytes].view(dtype).view(shape), slot

    def clear(self) -> None:
        """Free every buffer once nothing in flight reads it: the next
        take of each capacity allocates (and books) it again."""
        with self._lock:
            rings, self._rings = self._rings, {}
        for slots, _ in rings.values():
            for _, event in slots:
                if event is not None:
                    event.synchronize()


STAGING = PinnedRing()


class CudaPlanesBackend:
    """Solve backend of the session: planes on ``device``, the state
    carried between batches on it and updated in place. On the card
    everything runs on the current stream, in order: uploads, scatters,
    kernel, the copy back, through pinned buffers reused from a ring.
    ``solve_lazy`` returns without waiting for the card; ``materialize``
    waits for its batch alone; ``device_seconds`` reads the launch's
    timing events after it. ``transfer`` counts the bytes the pinned ring moved (``h2d``: pod
    streams, plane uploads and scatter entries; ``d2h``: assignments);
    ``take_transfer_bytes`` hands over and clears them."""

    name = "cuda-planes"

    def __init__(self, device: torch.device):
        self.device = device
        self.solves = 0
        self.scatters = {"add": 0, "set": 0}
        self.scatter_bytes = 0
        self.staging = STAGING
        self.transfer = {"h2d": 0, "d2h": 0}

    def take_transfer_bytes(self, *directions) -> dict:
        """The bytes moved since the last take, by direction (only
        ``directions``, when given), cleared."""
        out = {d: self.transfer[d] for d in directions or self.transfer}
        for d in out:
            self.transfer[d] = 0
        return out

    def prepare(self, cluster, batch) -> Tuple[PStatic, torch.Tensor]:
        ps, state = prepare(cluster, batch, self.device)
        self.transfer["h2d"] += sum(
            t.numel() * t.element_size()
            for t in (ps.ints, ps.f32s, ps.sc_meta, state))
        return ps, state

    def _upload(self, a: np.ndarray) -> Tuple[torch.Tensor, list]:
        """``a`` on the device, and the staging slot it went through (on
        the card a pinned buffer, copied from without waiting; None on
        the CPU)."""
        host = torch.from_numpy(np.ascontiguousarray(a))
        self.transfer["h2d"] += a.nbytes
        if self.device.type == "cpu":
            return host, None
        view, slot = self.staging.take(host.shape, host.dtype)
        # numpy's copy: one thread (torch's CPU copy of a large tensor
        # wakes its thread pool, which can take milliseconds)
        np.copyto(view.numpy(), a)
        return view.to(self.device, non_blocking=True), slot

    def _fence(self, slots):
        """Record an event after the work just queued and mark ``slots``
        in use until it fires. Returns the event (None on the CPU)."""
        if self.device.type == "cpu":
            return None
        event = torch.cuda.Event()
        event.record()
        for slot in slots:
            slot[1] = event
        return event

    def solve_lazy(self, params: SolverParams, ps: PStatic,
                   state: torch.Tensor, pod_ints: np.ndarray,
                   pod_floats: np.ndarray) -> SolveHandle:
        """Upload the pod stream and start the solve, which updates
        ``state`` in place; the assignments come back through
        ``materialize``."""
        check_profiles(pod_ints[:, ps.r + 2], ps.u)
        check_sv(pod_ints, ps.r, ps.sc, ps.t, ps.sv)
        run = solve
        stream = self.slot_route(ps, pod_ints, pod_floats)
        if stream is not None:
            run, (pod_ints, pod_floats) = solve_slots, stream
        ints, ints_slot = self._upload(pod_ints)
        floats, floats_slot = self._upload(pod_floats)
        if self.device.type == "cpu":
            assign = run(params, ps, state, ints, floats,
                         profiles_checked=True)
            self.solves += 1
            return SolveHandle(assign, assign, None, time.monotonic())
        started = torch.cuda.Event(enable_timing=True)
        ended = torch.cuda.Event(enable_timing=True)
        started.record()
        assign = run(params, ps, state, ints, floats, profiles_checked=True)
        ended.record()
        self.solves += 1
        host, host_slot = self.staging.take(assign.shape, assign.dtype,
                                            readback=True)
        host.copy_(assign, non_blocking=True)
        event = self._fence((ints_slot, floats_slot, host_slot))
        return SolveHandle(assign, host, event, time.monotonic(),
                           started, ended)

    @staticmethod
    def slot_route(ps: PStatic, pod_ints: np.ndarray, pod_floats: np.ndarray
                   ):
        """The batch's slot stream (``ops/slots.py::slot_stream``) when it
        takes the slot kernel: at least ``SPARSE_MIN_T`` terms, no
        shared-volume slots, a shape the cluster kernel does not take,
        every pod packed into slots and the slot kernel planned. None: the
        dense stream."""
        if (ps.t < SPARSE_MIN_T or ps.sv
                or plan_batch(ps).kernel == "cluster"):
            return None
        stream = slot_stream(pod_ints, pod_floats, ps.r, ps.sc, ps.t)
        if stream is None or plan_batch(ps, packs=True).kernel != "slots":
            return None
        return stream

    def materialize(self, handle: SolveHandle) -> np.ndarray:
        """Wait for the handle's batch and return its assignments (a
        copy: the host buffer serves a later solve)."""
        if handle.event is not None:
            handle.event.synchronize()
        out = handle.host.numpy().copy()
        self.transfer["d2h"] += out.nbytes
        return out

    def device_seconds(self, handle: SolveHandle) -> float:
        """The launch's time between its timing events (0 on the CPU);
        only after ``materialize``."""
        if handle.started is None:
            return 0.0
        return handle.started.elapsed_time(handle.ended) / 1000.0

    def solve(self, params: SolverParams, ps: PStatic, state: torch.Tensor,
              pod_ints: np.ndarray, pod_floats: np.ndarray) -> np.ndarray:
        """``solve_lazy`` and ``materialize`` in one call."""
        return self.materialize(self.solve_lazy(params, ps, state,
                                                pod_ints, pod_floats))

    def _scatter(self, planes: torch.Tensor, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray, accumulate: bool
                 ) -> int:
        """``vals`` put at (rows, cols) of ``planes`` in place, added with
        ``accumulate``; returns the bytes the entries took to the
        device."""
        flat = rows.astype(np.int64) * planes.shape[1] + cols
        idx, idx_slot = self._upload(flat)
        values, vals_slot = self._upload(vals.astype(np.int32))
        planes.view(-1).index_put_((idx,), values, accumulate=accumulate)
        self._fence((idx_slot, vals_slot))
        nbytes = flat.nbytes + 4 * vals.size
        self.scatter_bytes += nbytes
        return nbytes

    def scatter_state_add(self, state: torch.Tensor, rows: np.ndarray,
                          cols: np.ndarray, vals: np.ndarray) -> int:
        """Add ``vals`` at (rows, cols) of the state planes, in place.
        Targets are distinct but for (0, 0, 0) pads, which add nothing.
        Returns the bytes the entries took to the device."""
        self.scatters["add"] += 1
        return self._scatter(state, rows, cols, vals, accumulate=True)

    def scatter_static_set(self, ps: PStatic, rows: np.ndarray,
                           cols: np.ndarray, vals: np.ndarray) -> int:
        """Set the static int planes to ``vals`` at (rows, cols), in
        place. Pads repeat the last entry with its value, so the order of
        writes does not matter. Returns the bytes taken to the device."""
        self.scatters["set"] += 1
        return self._scatter(ps.ints, rows, cols, vals, accumulate=False)
