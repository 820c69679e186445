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
memory and the lines a window of pods needs cached in shared memory, a
window ahead, each window as long as its terms fit beside the running
one's); else the
wide kernel (the slot kernel's design over the dense stream with the term
rows read at L2, for any width: a pod of more than ``SPARSE_K`` term
references, shared-volume slots, a node axis too wide for the slot
kernel's cache). The backend
packs the slot stream (``solve_slots``) only for batches of at least
``SPARSE_MIN_T`` terms that the cluster kernel does not take, as the
reference routes its sparse scan. An epoch with shared-volume slots
(``PStatic.sv > 0``) never takes the slot kernel, as the reference's
sparse scan has no attach planes: the cluster and wide kernels and the
plain version carry them.

The sharded tier (``parallel/sharded.py``) launches the sharded kernel
(the wide kernel's body over S node shards: where S divides the cluster
size, every shard a group of blocks of one cluster, exchanging each pod's
best in distributed shared memory; else a cluster a shard, exchanging
through global memory) and the feasibility counts kernel through the same
wrapper: ``sharded_plan`` checks that the card holds the route's clusters
at once before it plans, and the launch checks it again.

Float scores are computed in the same order, with the same f32
operations, as the reference solve, so assignments agree exactly:
``score = bw*balanced + lw*least + sw*spread + aw*pref + stw*static``
summed left to right, ``pref`` accumulated over terms from 0 and the
soft-spread counts over constraints.
"""

from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops import build
from kubernetes_tpu_torch.ops.planes import (
    PStatic,
    prepare,
    prepare_state,
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

KERNEL_SOURCE = build.CSRC_DIR / "solve_kernel.cu"
# one block's shared memory on Hopper (227 KB), the block size and the
# largest pod chunk the kernels are written for (csrc/solve_kernel.cu)
SMEM_LIMIT = 232448
CLUSTER_THREADS = 512
POD_CHUNK = 32
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8


class LaunchPlan(NamedTuple):
    """How a solve launches: which kernel, its cluster size, threads per
    block, node columns per block (of a shard's, for the sharded kernel)
    and shared-memory bytes per block."""

    kernel: str             # "cluster", "slots", "wide" or "sharded"
    cluster: int
    threads: int
    cols_per_block: int
    smem_bytes: int
    chunk: int              # pod rows staged at a time (wide: 0 reads
                            # each row in place)


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


# the slot kernel's pod chunks staged at once (the one that runs, the next,
# where the next window of pods may start, and the one in flight) and the
# rows of a cache line (a term's owners, counts and codes)
SLOT_POD_BUFFERS = 3
CACHE_LINE_ROWS = 3


class SlotCache(NamedTuple):
    """The slot kernel's term-row cache for a plan (``slots_layout`` in
    the source): ``lines`` cached terms, ``need`` the fewest it runs with
    (``min(T, SPARSE_K)``: a window of one pod), and ``fixed_words`` the
    layout's words before the lines."""

    lines: int
    need: int
    fixed_words: int


def slot_cache(r: int, sc: int, t: int, u: int, cluster: int, threads: int,
               cols_per_block: int, chunk: int) -> SlotCache:
    """The slot kernel's layout but for its cache lines: the cluster
    kernel's without the term rows, three chunks of slot-stream pod rows
    (``R+4+2*SC+2*K`` ints and ``K`` weights a pod), the slot fact lists,
    a term's line and mark, and one window plan's misses and jobs; then
    as many lines (three rows of ``cols_per_block`` words, a key and a
    stamp) as fit one block's shared memory, at most T, never fewer than
    ``need``."""
    k = SPARSE_K
    rows = (r + 3 + sc) + (r + 2 + sc + 2 * u) + 1
    fixed = (rows * cols_per_block + t + 2 * sc
             + SLOT_POD_BUFFERS * chunk * (slot_width(r, sc) + k)
             + chunk * (8 + 3 * sc + 3 * k)
             + (sc + 2) * (threads // 32) + 2 * cluster * (sc + 2)
             + 2 * t + chunk * k + 2 + 2 * chunk * k)
    fixed = _round_up(fixed, 4)
    line = CACHE_LINE_ROWS * cols_per_block + 2
    need = min(t, k)
    lines = max(need, min(t, (SMEM_LIMIT // 4 - fixed) // line))
    return SlotCache(lines, need, fixed)


def slots_smem_bytes(r: int, sc: int, t: int, u: int, cluster: int,
                     threads: int, cols_per_block: int, chunk: int) -> int:
    """Shared memory of one block of the slot kernel, as its layout
    (``slots_layout`` in the source) lays it out: ``slot_cache``'s fixed
    part and its lines. Past the limit exactly when the lines that fit are
    fewer than ``need``."""
    cache = slot_cache(r, sc, t, u, cluster, threads, cols_per_block, chunk)
    return 4 * (cache.fixed_words
                + cache.lines * (CACHE_LINE_ROWS * cols_per_block + 2))


def wide_smem_bytes(r: int, sc: int, t: int, u: int, cluster: int,
                    threads: int, cols_per_block: int, chunk: int,
                    sv: int = 0, slices: bool = True) -> int:
    """Shared memory of one block of the wide kernel, as its layout
    (``wide_layout`` in the source) lays it out: with ``slices`` the slot
    kernel's slices of the non-term state and static rows (else those
    rows are read at L2); a score row, the totals, ``sc_meta``, two
    chunks of dense pod rows and weights (none at ``chunk`` 0, where
    each row is read in place), one chunk's facts (one pod's at chunk 0:
    eight counts, three constraint lists and one list of term
    references), the warp slots and the exchange slots."""
    rows = (r + 3 + sc) + (r + 2 + sc + 2 * u) if slices else 0
    words = ((rows + 1) * cols_per_block + t + 2 * sc
             + 2 * chunk * (pod_width(r, sc, t, sv) + t)
             + max(chunk, 1) * (8 + 3 * sc + t)
             + (sc + 2) * (threads // 32) + 2 * cluster * (sc + 2))
    return 4 * words


def sharded_smem_bytes(r: int, sc: int, t: int, u: int, cluster: int,
                       threads: int, cols_per_block: int, chunk: int,
                       sv: int = 0, slices: bool = True) -> int:
    """Shared memory of one block of the sharded kernel (``sharded_layout``
    in the source): the wide kernel's, and the mesh's winner of a pod
    (score and index) in two parities."""
    return wide_smem_bytes(r, sc, t, u, cluster, threads, cols_per_block,
                           chunk, sv, slices) + 4 * 4


def wide_slices(plan: LaunchPlan, r: int, sc: int, t: int, u: int,
                sv: int = 0) -> bool:
    """Whether a wide or sharded plan keeps the slices in shared memory:
    exactly when that layout fits, the rule the source applies too."""
    smem = sharded_smem_bytes if plan.kernel == "sharded" else \
        wide_smem_bytes
    return smem(r, sc, t, u, plan.cluster, plan.threads,
                plan.cols_per_block, plan.chunk, sv) <= SMEM_LIMIT


def sharded_groups(plan: LaunchPlan, shards: int, n: int) -> int:
    """The sharded plan's route, as the launch reads it from the cut: the
    blocks a shard of its one cluster where the plan's cluster holds
    ``shards`` groups of blocks that cover a shard's ``n // shards``
    columns, else 0 (the global route: a cluster a shard)."""
    g, rest = divmod(plan.cluster, shards)
    return g if rest == 0 and g * plan.cols_per_block >= n // shards else 0


# the sharded kernel's exchange workspace (``sharded_workspace`` in the
# source): a flag a parity and shard for each round, on a 128-byte line of
# its own, the error word, the offers and the domain minima. The one-cluster
# route is given it too and touches none of it, so its error word stays 0
FLAG_STRIDE = 32
EXCHANGE_ERRORS = {
    1: "a shard's wait for another's offer ran out",
    2: "a pod with hard spread reached the instance without the round of "
       "domain minima",
}


def exchange_words(shards: int, sc: int, t: int) -> int:
    """4-byte words of the sharded kernel's exchange workspace."""
    return (4 * shards * FLAG_STRIDE + FLAG_STRIDE
            + 2 * shards * (2 + sc + t) + 2 * shards * sc)


def exchange_error_word(shards: int) -> int:
    """The error word's index in the exchange workspace."""
    return 4 * shards * FLAG_STRIDE


def check_exchange(code: int) -> None:
    """Raise RuntimeError for a nonzero error word of a sharded launch."""
    if code:
        raise RuntimeError("sharded solve kernel failed: "
                           + EXCHANGE_ERRORS.get(code, f"error {code}"))


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
    it fits: the cluster kernel's cut of the node axis and the largest pod
    chunk (``POD_CHUNK`` down to 1) whose staging leaves the cache its
    ``need`` of lines; where not even one pod's chunk does, the chunk-1
    plan, past the limit. The kernel cuts each chunk into windows of pods
    whose terms fit the lines beside the running window's."""
    c = cluster_candidate(n, r, sc, t, u, max_cluster)
    for chunk in range(POD_CHUNK, 0, -1):
        smem = slots_smem_bytes(r, sc, t, u, c.cluster, c.threads,
                                c.cols_per_block, chunk)
        if smem <= SMEM_LIMIT:
            break
    return c._replace(kernel="slots", smem_bytes=smem, chunk=chunk)


def wide_candidate(n: int, r: int, sc: int, t: int, u: int,
                   max_cluster: int = MAX_CLUSTER, sv: int = 0,
                   chunk: int = None, kernel: str = "wide",
                   shards: int = 1) -> LaunchPlan:
    """The wide kernel's launch over ``n`` node columns: the cluster
    kernel's cut of the node axis, and the first layout that fits one
    block's shared memory, slices in shared memory before slices at L2,
    each with the largest pod chunk (``POD_CHUNK`` down to 1, then 0:
    rows read in place), or ``chunk`` where given. Where none fits, the
    plan at L2 with ``chunk`` (default 0), which the launch refuses.

    ``kernel="sharded"``: the sharded kernel's launch over ``shards``
    shards of ``n`` columns each, on its layout (``sharded_smem_bytes``),
    by the route rule: where ``shards`` divides ``max_cluster``, one
    cluster, each shard's columns cut into ``g`` blocks by the cluster
    kernel's cut at ``max_cluster // shards`` blocks (``cluster`` is
    ``shards * g``: ``sharded_groups``); else the global route, a cluster
    a shard cut at ``max_cluster`` blocks."""
    if kernel == "sharded" and max_cluster % shards == 0:
        g = cluster_candidate(n, r, sc, t, u, max_cluster // shards, sv)
        c = g._replace(cluster=shards * g.cluster)
    else:
        c = cluster_candidate(n, r, sc, t, u, max_cluster, sv)
    smem = sharded_smem_bytes if kernel == "sharded" else wide_smem_bytes

    def plan(ch, slices):
        return c._replace(kernel=kernel, chunk=ch, smem_bytes=smem(
            r, sc, t, u, c.cluster, c.threads, c.cols_per_block, ch, sv,
            slices))

    chunks = range(POD_CHUNK, -1, -1) if chunk is None else (chunk,)
    for slices in (True, False):
        for ch in chunks:
            p = plan(ch, slices)
            if p.smem_bytes <= SMEM_LIMIT:
                return p
    return plan(chunks[-1], False)


def plan_launch(n: int, r: int, sc: int, t: int, u: int,
                max_cluster: int = MAX_CLUSTER, packs: bool = False,
                sv: int = 0) -> LaunchPlan:
    """The launch of a solve over ``n`` node columns, the first that fits
    one block's shared memory (227 KB): the cluster kernel
    (``cluster_candidate``); the slot kernel (``slots_candidate``) when
    the batch ``packs`` into slots and has no shared-volume slots
    (``sv``); the wide kernel (``wide_candidate``)."""
    plan = cluster_candidate(n, r, sc, t, u, max_cluster, sv)
    if plan.smem_bytes <= SMEM_LIMIT:
        return plan
    if packs and not sv:
        plan = slots_candidate(n, r, sc, t, u, max_cluster)
        if plan.smem_bytes <= SMEM_LIMIT:
            return plan
    return wide_candidate(n, r, sc, t, u, max_cluster, sv)


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
def build_kernel() -> Path:
    """Compile ``csrc/solve_kernel.cu`` for sm_90a into a shared library
    under ``build/`` (``ops/build.py``), unless it is built; returns the
    library's path."""
    return build.build_kernel(KERNEL_SOURCE)


class SolveKernel:
    """ctypes binding of the CUDA solve kernels. ``counts`` holds the
    launches this wrapper made of each kernel ("cluster", "slots",
    "wide"); ``launches`` is their sum. The library is built and loaded
    on the first launch.

    Compiles: the library's build and load, and the first launch of each
    kernel instance (a kernel with shared-volume planes or without, the
    wide kernel with its slices in shared memory or at L2; under
    lazy module loading that launch loads the module), are timed on the
    host where they happen and reported to the device profiler
    (``note_compile``), which books them to the solve cycle open on this
    thread. ``compiles`` lists them: (what, seconds)."""

    def __init__(self):
        self.counts = {"cluster": 0, "slots": 0, "wide": 0, "sharded": 0,
                       "counts": 0}
        self._lib = None
        self._lock = threading.Lock()
        # sessions on several threads (a replica set) launch at once
        self._count_lock = threading.Lock()
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
        with self._count_lock:
            for k in self.counts:
                self.counts[k] = 0

    def _count(self, kernel: str) -> None:
        with self._count_lock:
            self.counts[kernel] += 1

    def _load(self):
        with self._lock:
            if self._lib is None:
                t0 = time.monotonic()
                lib = ctypes.CDLL(str(build_kernel()))
                p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                sharded = [p] * 10 + [i] * 16 + [f] * 5 + [p]
                binds = [("ktt_solve_sharded_launch", sharded),
                         ("ktt_solve_sharded_launch_one_short", sharded),
                         ("ktt_sharded_workspace_words", [i] * 3),
                         ("ktt_feasible_counts_launch",
                          [p] * 3 + [i] * 9 + [p])]
                for name in ("cluster", "slots", "wide", "sharded"):
                    if name != "sharded":
                        binds.append((f"ktt_solve_{name}_launch",
                                      [p] * 7 + [i] * 13 + [f] * 5 + [p]))
                    binds += [(f"ktt_{name}_max_active", [i] * 3),
                              (f"ktt_{name}_smem_bytes", [i] * 9)]
                for fn, args in binds:
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = ctypes.c_int
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

    def wide_plan(self, ps: PStatic) -> LaunchPlan:
        """The wide kernel's own launch for these planes on this card
        (``wide_candidate``, 16 blocks or the portable 8), whatever
        ``plan_launch`` would pick."""
        key = (ps.ints.shape[1], ps.r, ps.sc, ps.t, ps.u)
        if (key, "wide", ps.sv) not in self._plans:
            self._plans[key, "wide", ps.sv] = self._fitted(
                lambda size: wide_candidate(*key, max_cluster=size,
                                            sv=ps.sv), ps)
        return self._plans[key, "wide", ps.sv]

    def sharded_plan(self, ss, shards: int) -> LaunchPlan:
        """The sharded kernel's launch for these planes over ``shards``
        node shards on this card (``wide_candidate(kernel="sharded")`` over
        a shard's columns): the first cluster size of 16, 8 and 4 blocks
        whose route the card holds, one cluster of every shard's blocks
        where ``shards`` divides the size, else ``shards`` clusters at
        once. Raises RuntimeError where none does: a cluster waiting for
        one not yet running would spin."""
        n = ss.ints.shape[1]
        if shards < 1 or shards > 32 or n % shards != 0:
            raise ValueError(f"{n} node columns do not split into {shards} "
                             "shards (at most 32)")
        key = (n // shards, ss.r, ss.sc, ss.t, ss.u)
        if (key, "sharded", ss.sv, shards) not in self._plans:
            lib = self._load()
            fits = []
            for size in (MAX_CLUSTER, PORTABLE_CLUSTER, 4):
                plan = wide_candidate(*key, max_cluster=size, sv=ss.sv,
                                      kernel="sharded", shards=shards)
                if plan.smem_bytes > SMEM_LIMIT:
                    continue
                active = self._active(lib, plan, ss)
                fits.append((plan.cluster, active))
                if active >= (1 if sharded_groups(plan, shards, n)
                              else shards):
                    self._plans[key, "sharded", ss.sv, shards] = plan
                    break
            else:
                raise RuntimeError(
                    f"the card holds no {shards} clusters of the sharded "
                    f"kernel at once (cluster size, clusters held: {fits})")
        return self._plans[key, "sharded", ss.sv, shards]

    def check_sharded(self, ss, planes: torch.Tensor, totals: torch.Tensor,
                      pod_ints: torch.Tensor, pod_floats: torch.Tensor
                      ) -> None:
        """Raise ValueError on inputs the sharded kernel does not take
        (the dense stream's shapes, as ``check``; the shards' totals
        ``[S, T]`` and the domain existence ``[U, SC]``)."""
        shards = totals.shape[0]
        self.check(ss, planes, pod_ints, pod_floats, profiles=False)
        for tensor, shape in ((totals, (shards, ss.t)),
                              (ss.has_dom, (ss.u, ss.sc))):
            if tensor.device != planes.device or tensor.dtype != torch.int32 \
                    or tuple(tensor.shape) != shape \
                    or not tensor.is_contiguous():
                raise ValueError(
                    f"sharded kernel wants a contiguous int32 {shape} on "
                    f"{planes.device}; got {tensor.dtype} "
                    f"{tuple(tensor.shape)} on {tensor.device}")

    def launch_sharded(self, params: SolverParams, ss, planes: torch.Tensor,
                       totals: torch.Tensor, pod_ints: torch.Tensor,
                       pod_floats: torch.Tensor, plan: LaunchPlan = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Check and launch the sharded kernel over ``totals.shape[0]``
        shards (``plan``, or ``sharded_plan``'s) on the current stream,
        without synchronising: the planes (but their totals row) and the
        shards' totals are updated in place. Returns the assignments and
        the exchange's error word (a one-element tensor; nonzero:
        ``check_exchange`` raises). The pods' profile indices and volume
        references are the caller's to check (``check_profiles``,
        ``check_sv``)."""
        shards = totals.shape[0]
        self.check_sharded(ss, planes, totals, pod_ints, pod_floats)
        plan = plan or self.sharded_plan(ss, shards)
        lib = self._load()
        n, b = ss.ints.shape[1], pod_ints.shape[0]
        one = sharded_groups(plan, shards, n) > 0
        instance = ("sharded", ss.sv > 0)
        if not wide_slices(plan, ss.r, ss.sc, ss.t, ss.u, ss.sv):
            instance += ("at L2",)
        if not one:
            instance += ("global", "hard") if ss.any_hard else ("global",)
        first = instance not in self.launched
        t0 = time.monotonic()
        dev = planes.device
        assign = torch.empty(b, dtype=torch.int32, device=dev)
        words = exchange_words(shards, ss.sc, ss.t)
        ws = torch.zeros(words, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ktt_solve_sharded_launch(
            ss.sc_meta.data_ptr(), pod_ints.data_ptr(), pod_floats.data_ptr(),
            ss.ints.data_ptr(), ss.f32s.data_ptr(), planes.data_ptr(),
            assign.data_ptr(), ss.has_dom.data_ptr(), totals.data_ptr(),
            ws.data_ptr(), words, ss.r, ss.sc, ss.t, ss.u, ss.v, ss.sv, n, b,
            shards, int(ss.any_hard), plan.cluster, plan.threads,
            plan.cols_per_block, plan.chunk, plan.smem_bytes,
            *params.as_tuple(), stream)
        if err != 0:
            raise RuntimeError(f"solve sharded kernel launch failed: CUDA "
                               f"error {err}")
        self._count("sharded")
        if first:
            self.launched.add(instance)
            self.note_compile("first launch " + " ".join(
                [instance[0]] + (["sv"] if instance[1] else [])
                + list(instance[2:])), time.monotonic() - t0)
        e = exchange_error_word(shards)
        return assign, ws[e:e + 1]

    def launch_counts(self, ss, pod_ints: torch.Tensor, shards: int,
                      batch_axis: int = 1, profiles: bool = True
                      ) -> torch.Tensor:
        """Launch the feasibility counts kernel on the current stream: per
        pod the nodes that are valid, in its profile's static mask and fit
        its requests. The ``batch_axis`` x ``shards`` mesh must split the
        pods and the node columns; the counts do not depend on it. With
        ``profiles`` the pods' profile indices are checked here, which
        waits for the stream; with ``profiles`` False the caller has
        checked them on the host (``check_profiles``), and the call queues
        the kernel alone, which writes every count, and returns."""
        r, sc, t, u = ss.r, ss.sc, ss.t, ss.u
        n, b = ss.ints.shape[1], pod_ints.shape[0]
        if n % shards != 0 or b % batch_axis != 0:
            raise ValueError(f"{b} pods x {n} nodes do not split over a "
                             f"{batch_axis} x {shards} mesh")
        if pod_ints.device != ss.ints.device or pod_ints.dtype != torch.int32 \
                or pod_ints.dim() != 2 or not pod_ints.is_contiguous() \
                or pod_ints.shape[1] < r + 3:
            raise ValueError("counts kernel wants the contiguous int32 pod "
                             f"stream on {ss.ints.device}")
        if profiles:
            check_profiles(pod_ints[:, r + 2], u)
        lib = self._load()
        first = ("counts",) not in self.launched
        t0 = time.monotonic()
        counts = torch.empty(b, dtype=torch.int32, device=pod_ints.device)
        stream = torch.cuda.current_stream(pod_ints.device).cuda_stream
        err = lib.ktt_feasible_counts_launch(
            pod_ints.data_ptr(), ss.ints.data_ptr(), counts.data_ptr(), r, sc,
            t, u, n, b, pod_ints.shape[1], shards, batch_axis, stream)
        if err != 0:
            raise RuntimeError(f"feasible counts kernel launch failed: CUDA "
                               f"error {err}")
        self._count("counts")
        if first:
            self.launched.add(("counts",))
            self.note_compile("first launch counts", time.monotonic() - t0)
        return counts

    def _fitted(self, make, ps: PStatic) -> LaunchPlan:
        """``make(16)``, or ``make(8)`` where the card holds no cluster of
        the first's shape."""
        lib = self._load()
        plan = make(MAX_CLUSTER)
        if self._active(lib, plan, ps) < 1:
            plan = make(PORTABLE_CLUSTER)
        if self._active(lib, plan, ps) < 1:
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
        if plan.kernel == "wide" and not wide_slices(plan, ps.r, ps.sc, ps.t,
                                                     ps.u, ps.sv):
            instance += ("at L2",)
        first = instance not in self.launched
        t0 = time.monotonic()
        n, b = ps.ints.shape[1], pod_ints.shape[0]
        assign = torch.empty(b, dtype=torch.int32, device=state.device)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        ptrs = (ps.sc_meta.data_ptr(), pod_ints.data_ptr(),
                pod_floats.data_ptr(), ps.ints.data_ptr(), ps.f32s.data_ptr(),
                state.data_ptr(), assign.data_ptr())
        dims = (ps.r, ps.sc, ps.t, ps.u, ps.v, ps.sv, n, b)
        err = getattr(lib, f"ktt_solve_{plan.kernel}_launch")(
            *ptrs, *dims, plan.cluster, plan.threads, plan.cols_per_block,
            plan.chunk, plan.smem_bytes, *params.as_tuple(), stream)
        if err != 0:
            raise RuntimeError(f"solve {plan.kernel} kernel launch failed: "
                               f"CUDA error {err}")
        self._count(plan.kernel)
        if first:
            self.launched.add(instance)
            self.note_compile(f"first launch {plan.kernel}"
                              + (" sv" if instance[1] else "")
                              + "".join(f" {x}" for x in instance[2:]),
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
    err: object = None      # the sharded kernel's error word, on the host


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
    # node shards the encoder splits its node-column fill into
    encode_shards = 1

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

    def prepare_state_only(self, cluster, batch) -> torch.Tensor:
        """Fresh state planes alone: the static planes of the same
        fingerprint stay resident."""
        state = prepare_state(cluster, batch, self.device)
        self.transfer["h2d"] += state.numel() * state.element_size()
        return state

    @staticmethod
    def warm_state(state: torch.Tensor) -> torch.Tensor:
        """A copy of the carried state for a warm solve to consume."""
        return state.clone()

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
