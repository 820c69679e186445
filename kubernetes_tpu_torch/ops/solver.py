"""Solve parameters, the packed pod stream, and the legacy per-pod scan.

A batch is solved in queue order, one pod at a time: every node is
checked (capacity, pod count, static profile mask, hard topology spread,
inter-pod (anti-)affinity) and scored (balanced and least allocation,
soft spread, preferred affinity, static score); the best node, lowest
index on ties, takes the pod, and the state is updated before the next
pod. ``ops.solve`` runs that loop over the planes layout (the batch
path); this module runs it over the legacy layout, whose state is count
tables indexed by topology value (``sc_counts [SC, V+1]``,
``term_counts`` / ``term_owners [T, V+1]``, read through the nodes'
codes clamped to V), as ``kubernetes_tpu/ops/solver.py`` does.

The scan serves the cluster autoscaler's what-if (``solve_whatif``):
hypothetical template nodes appended as extra columns are pushed down
by a static-score penalty, so pods spill onto them only where no real
node fits, and columns can be disabled. ``solve_packed`` takes the plain
PyTorch loop (``solve_scan_plain``) for CPU tensors and launches the
hand-written kernel (``csrc/scan_kernel.cu``, ``solve_scan_kernel``) for
CUDA tensors, never one for the other. On the card a what-if runs on a
stream of its own, with pageable uploads, off the batch loop's stream
and its pinned staging ring (the autoscaler solves on its own thread)."""

from __future__ import annotations

import ctypes
import threading
import time
from dataclasses import astuple, dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.ops import build

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


# ----------------------------------------------------------------------
# the legacy scan

# keeps a column feasible but below every real node's score: the scan
# spills onto a penalized column only when no unpenalized node is
# feasible. Real scores are a few hundred, so a tier of 1e6 separates
# real < upcoming < virtual columns.
VIRTUAL_NODE_PENALTY = np.float32(1.0e6)
SCAN_SOURCE = build.CSRC_DIR / "scan_kernel.cu"
# columns a thread owns, and the block sizes of the kernel's instances:
# K < 8 with at most 512 threads, K = 8 with up to 1,024 (past 2,048
# columns)
SCAN_KS = (1, 2, 4, 8)
SCAN_SMALL_BLOCK = 512
SCAN_LARGE_BLOCK = 1024
SCAN_MAX_CHUNK = 32
SCAN_WARP_SLOTS = 32
SCAN_FACTS_HEADER = 16
# one block's shared memory on Hopper (227 KB)
SCAN_SMEM_LIMIT = 232448


class ScanPlan(NamedTuple):
    """One launch's shape: ``threads`` threads owning ``k`` columns each,
    pod rows staged ``chunk`` at a time, where the value-indexed tables
    and the column-owned arrays live, and the shared-memory bytes."""

    threads: int
    k: int
    chunk: int
    tables_in_smem: bool
    cols_in_smem: bool
    smem_bytes: int


def scan_col_words(sc: int, t: int, n_cols: int) -> int:
    """Words of the column-owned arrays over ``n_cols`` (k x threads)
    columns: the codes and the three tables' counts at them."""
    return (2 * sc + 3 * t) * n_cols


def scan_smem_words(r: int, sc: int, t: int, v: int, n_cols: int,
                    chunk: int, tables: bool, cols: bool) -> int:
    """Words of the kernel's shared-memory layout (``scan_layout`` in
    ``csrc/scan_kernel.cu`` sums the same): the warp winners (two halves
    of a 64-bit slot a warp); ``chunk`` pods' facts (a header of 16
    words and five entry lists, rounded up to four words); the tables [SC+2T, V+1] when ``tables``; the totals
    [T]; the column arrays when ``cols``; two buffers of ``chunk`` pod
    rows and weights; the domain minima [SC, 32]."""
    width = r + 4 + 2 * sc + 3 * t
    return 4 * SCAN_WARP_SLOTS \
        + ((sc + 2 * t) * (v + 1) if tables else 0) + t \
        + (scan_col_words(sc, t, n_cols) if cols else 0) \
        + 2 * chunk * (width + t) \
        + chunk * (-(-(SCAN_FACTS_HEADER + 3 * sc + 2 * t) // 4) * 4) \
        + sc * SCAN_WARP_SLOTS


def scan_plan(r: int, sc: int, t: int, v: int, n: int, b: int,
              tables=None, cols=None, k=None) -> ScanPlan:
    """The scan kernel's launch shape for these dims. ``k`` is the least
    of ``SCAN_KS`` with which 512 threads cover N (else 8, with up to
    1,024 threads): more warps with fewer columns each are faster on
    this latency-bound loop; threads are the warps that cover N. The chunk is 32
    pod rows (fewer when B is smaller), halved until the layout fits one
    block's shared memory, trying first the column arrays and the tables
    both in shared memory, then the tables in global memory, then the
    column arrays, then both. ``tables``, ``cols`` (True or False) and
    ``k`` force a choice. Raises ValueError for a shape no layout
    takes."""
    if k is None:
        k = next((x for x in SCAN_KS if n <= SCAN_SMALL_BLOCK * x),
                 SCAN_KS[-1])
    elif k not in SCAN_KS:
        raise ValueError(f"k={k} is not one of {SCAN_KS}")
    threads = max(32, -(-(-(-n // k)) // 32) * 32)
    limit = SCAN_LARGE_BLOCK if k == SCAN_KS[-1] else SCAN_SMALL_BLOCK
    if threads > limit:
        raise ValueError(f"no scan layout covers N={n} with k={k}: "
                         f"{threads} threads past {limit}")
    placements = [(c, tb) for c in (True, False) for tb in (True, False)
                  if cols in (None, c) and tables in (None, tb)]
    chunk = min(SCAN_MAX_CHUNK, max(b, 1))
    while chunk >= 1:
        for c, tb in placements:
            nbytes = 4 * scan_smem_words(r, sc, t, v, k * threads, chunk,
                                         tb, c)
            if nbytes <= SCAN_SMEM_LIMIT:
                return ScanPlan(threads, k, chunk, tb, c, nbytes)
        chunk //= 2
    raise ValueError(f"no scan layout of R={r} SC={sc} T={t} V={v} N={n} "
                     "fits one block's shared memory")


class ScanStatic(NamedTuple):
    """What a scan reads and never writes (int32 but the scores)."""

    allocatable: torch.Tensor    # [N, R]
    max_pods: torch.Tensor       # [N]
    static_masks: torch.Tensor   # [U, N] 0/1
    static_scores: torch.Tensor  # [U, N] f32
    sc_codes: torch.Tensor       # [SC, N], clamped to V
    sc_max_skew: torch.Tensor    # [SC]
    sc_hard: torch.Tensor        # [SC] 0/1
    sc_domain: torch.Tensor      # [U, SC, V+1] 0/1
    term_codes: torch.Tensor     # [T, N], clamped to V
    node_valid: torch.Tensor     # [N] 0/1


class ScanState(NamedTuple):
    """What a scan updates in place (int32)."""

    requested: torch.Tensor          # [N, R]
    nonzero_requested: torch.Tensor  # [N, 2]
    pod_count: torch.Tensor          # [N]
    sc_counts: torch.Tensor          # [SC, V+1]
    term_counts: torch.Tensor        # [T, V+1]
    term_owners: torch.Tensor        # [T, V+1]


def _tensor(a: np.ndarray, dtype, device, copy: bool = False
            ) -> torch.Tensor:
    """``a`` as a tensor on ``device``; on the CPU it shares ``a``'s
    memory unless ``copy``."""
    a = np.array(a, dtype=dtype, copy=True) if copy else \
        np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a).to(device)


def build_static(cluster, batch, device, static_scores=None,
                 node_valid=None) -> ScanStatic:
    """The scan's static arrays on ``device`` (no default: the caller
    names it); ``static_scores`` and ``node_valid`` replace the batch's
    scores and the real-node columns."""
    n = cluster.allocatable.shape[0]
    v = batch.num_values
    sc_codes = np.minimum(cluster.topo_codes[:, batch.sc_key_idx].T, v)
    term_codes = np.minimum(cluster.topo_codes[:, batch.term_key_idx].T, v)
    if node_valid is None:
        node_valid = np.zeros(n, dtype=bool)
        node_valid[: cluster.num_real_nodes] = True
    if static_scores is None:
        static_scores = batch.static_scores
    i32 = np.int32
    return ScanStatic(
        allocatable=_tensor(cluster.allocatable, i32, device),
        max_pods=_tensor(cluster.max_pods, i32, device),
        static_masks=_tensor(batch.static_masks, i32, device),
        static_scores=_tensor(static_scores, np.float32, device),
        sc_codes=_tensor(sc_codes, i32, device),
        sc_max_skew=_tensor(batch.sc_max_skew, i32, device),
        sc_hard=_tensor(batch.sc_hard, i32, device),
        sc_domain=_tensor(batch.sc_domain, i32, device),
        term_codes=_tensor(term_codes, i32, device),
        node_valid=_tensor(node_valid, i32, device),
    )


def build_state(cluster, batch, device) -> ScanState:
    """The scan's state on ``device`` (no default: the caller names it):
    copies, updated in place by a solve."""
    return ScanState(*(_tensor(a, np.int32, device, copy=True) for a in (
        cluster.requested, cluster.nonzero_requested, cluster.pod_count,
        batch.sc_counts, batch.term_counts, batch.term_owners)))


def _scan_dims(static: ScanStatic) -> Tuple[int, ...]:
    """(R, SC, T, U, V, N)."""
    n, r = static.allocatable.shape
    u, sc, v1 = static.sc_domain.shape
    return r, sc, static.term_codes.shape[0], u, v1 - 1, n


def solve_scan_plain(params: SolverParams, static: ScanStatic,
                     state: ScanState, pod_ints: torch.Tensor,
                     pod_floats: torch.Tensor) -> torch.Tensor:
    """The scan as a per-pod loop of tensor operations over the node
    axis, on any device; ``state`` is updated in place. Per-pod flags are
    read on the host, so constraints and terms a pod does not use are
    skipped (they add nothing). Returns the assignment of each row."""
    r, scn, tn, _, v, n = _scan_dims(static)
    dev = static.allocatable.device
    bw, lw, sw, aw, stw = params.as_tuple()
    o_nz, o_prof, o_valid, o_psc = r, r + 2, r + 3, r + 4
    o_scm = o_psc + scn
    o_mb, o_oa, o_oan = o_scm + scn, o_scm + scn + tn, o_scm + scn + 2 * tn
    node_valid = static.node_valid > 0
    alloc = static.allocatable
    alloc_cpu = torch.clamp(alloc[:, 0], min=1).to(torch.float32)
    alloc_mem = torch.clamp(alloc[:, 1], min=1).to(torch.float32)
    hard = (static.sc_hard > 0).tolist()
    max_skew = static.sc_max_skew.tolist()
    hundred = torch.tensor(100.0, dtype=torch.float32, device=dev)
    rows_sc = torch.arange(scn, device=dev)
    rows_t = torch.arange(tn, device=dev)
    out = []
    for row, wrow in zip(pod_ints.tolist(), pod_floats.tolist()):
        if row[o_valid] == 0:
            out.append(-1)
            continue
        profile = row[o_prof]
        req = torch.tensor(row[:r], dtype=torch.int32, device=dev)
        # ---- feasibility
        feasible = node_valid & (static.static_masks[profile] > 0)
        feasible &= torch.all(state.requested + req <= alloc, dim=1)
        feasible &= state.pod_count < static.max_pods
        soft_counts = torch.zeros(n, dtype=torch.int32, device=dev)
        any_soft = False
        for c in range(scn):
            if not row[o_psc + c]:
                continue
            codes = static.sc_codes[c]
            counts_at = state.sc_counts[c][codes]
            if hard[c]:
                dom = static.sc_domain[profile, c, :v] > 0
                min_c = int(torch.where(dom, state.sc_counts[c, :v],
                                        BIG).min()) if bool(dom.any()) else 0
                skew = counts_at + row[o_scm + c] - min_c
                feasible &= ~((skew > max_skew[c]) | (codes >= v))
            else:
                soft_counts += counts_at
                any_soft = True
        has_aff, no_any, self_all = False, True, True
        aff_sat = torch.ones(n, dtype=torch.bool, device=dev)
        pref = torch.zeros(n, dtype=torch.float32, device=dev)
        for t in range(tn):
            mb, oa, oan, w = (row[o_mb + t], row[o_oa + t], row[o_oan + t],
                              wrow[t])
            if not (mb or oa or oan) and w == 0.0:
                continue
            codes = static.term_codes[t]
            tcounts_at = state.term_counts[t][codes]
            if mb:
                feasible &= state.term_owners[t][codes] <= 0
            if oan:
                feasible &= tcounts_at <= 0
            if oa:
                has_aff = True
                aff_sat &= (tcounts_at > 0) & (codes < v)
                no_any &= int(state.term_counts[t, :v].sum()) == 0
                self_all &= mb != 0
            if w != 0.0:
                pref += w * tcounts_at.to(torch.float32)
        if has_aff and not (no_any and self_all):
            feasible &= aff_sat
        if not bool(feasible.any()):
            out.append(-1)
            continue
        # ---- scores, in the reference's order of additions
        cpu_frac = (state.nonzero_requested[:, 0] + row[o_nz]).to(
            torch.float32) / alloc_cpu
        mem_frac = (state.nonzero_requested[:, 1] + row[o_nz + 1]).to(
            torch.float32) / alloc_mem
        over = (cpu_frac >= 1.0) | (mem_frac >= 1.0)
        balanced = torch.where(
            over, 0.0, (1.0 - torch.abs(cpu_frac - mem_frac)) * 100.0)
        least = (torch.clamp(1.0 - cpu_frac, 0.0, 1.0)
                 + torch.clamp(1.0 - mem_frac, 0.0, 1.0)) * 50.0
        if any_soft:
            # a tensor numerator: one IEEE division, as the kernel's
            spread = torch.div(hundred, 1.0 + soft_counts.to(torch.float32))
        else:
            spread = torch.zeros(n, dtype=torch.float32, device=dev)
        score = (bw * balanced + lw * least + sw * spread + aw * pref
                 + stw * static.static_scores[profile])
        score = torch.where(feasible, score, NEG_INF)
        chosen = int(torch.argmax(score))   # the first of equal maxima
        out.append(chosen)
        # ---- commit
        state.requested[chosen] += req
        state.nonzero_requested[chosen, 0] += row[o_nz]
        state.nonzero_requested[chosen, 1] += row[o_nz + 1]
        state.pod_count[chosen] += 1
        sc_inc = torch.tensor(row[o_scm:o_scm + scn], dtype=torch.int32,
                              device=dev)
        state.sc_counts[rows_sc, static.sc_codes[:, chosen]] += sc_inc
        codes = static.term_codes[:, chosen]
        state.term_counts[rows_t, codes] += torch.tensor(
            row[o_mb:o_mb + tn], dtype=torch.int32, device=dev)
        state.term_owners[rows_t, codes] += torch.tensor(
            row[o_oan:o_oan + tn], dtype=torch.int32, device=dev)
    return torch.tensor(out, dtype=torch.int32, device=dev)


class ScanKernel:
    """ctypes binding of ``solve_scan_kernel`` (``csrc/scan_kernel.cu``).
    ``launches`` counts the launches this wrapper made. The library is
    built (``ops/build.py``) and loaded on the first launch; the build
    and load, and the first launch, are timed where they happen and
    reported to the device profiler as compiles (``compiles``: (what,
    seconds)), as ``ops.solve.SolveKernel`` does."""

    def __init__(self):
        self.launches = 0
        self.launched = False
        self.compiles = []
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        self.launches = 0

    def note_compile(self, what: str, seconds: float) -> None:
        self.compiles.append((what, seconds))
        get_devprof().on_compile(seconds)

    def _load(self):
        with self._lock:
            if self._lib is None:
                t0 = time.monotonic()
                lib = ctypes.CDLL(str(build.build_kernel(SCAN_SOURCE)))
                p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.ktt_solve_scan_launch.argtypes = (
                    [p] * 20 + [i] * 13 + [f] * 5 + [p])
                lib.ktt_solve_scan_launch.restype = ctypes.c_int
                lib.ktt_scan_smem_bytes.argtypes = [i] * 10
                lib.ktt_scan_smem_bytes.restype = ctypes.c_longlong
                self._lib = lib
                self.note_compile("load scan", time.monotonic() - t0)
        return self._lib

    @staticmethod
    def check(static: ScanStatic, state: ScanState, pod_ints: torch.Tensor,
              pod_floats: torch.Tensor) -> None:
        """Raise ValueError on inputs the kernel does not take: every
        tensor contiguous, int32 (f32 scores and weights), on one device,
        at the shapes the dims give; pod profiles in [0, U), codes in
        [0, V]."""
        r, sc, t, u, v, n = _scan_dims(static)
        b = pod_ints.shape[0]
        expected = [
            (static.allocatable, torch.int32, (n, r)),
            (static.max_pods, torch.int32, (n,)),
            (static.static_masks, torch.int32, (u, n)),
            (static.static_scores, torch.float32, (u, n)),
            (static.sc_codes, torch.int32, (sc, n)),
            (static.sc_max_skew, torch.int32, (sc,)),
            (static.sc_hard, torch.int32, (sc,)),
            (static.sc_domain, torch.int32, (u, sc, v + 1)),
            (static.term_codes, torch.int32, (t, n)),
            (static.node_valid, torch.int32, (n,)),
            (state.requested, torch.int32, (n, r)),
            (state.nonzero_requested, torch.int32, (n, 2)),
            (state.pod_count, torch.int32, (n,)),
            (state.sc_counts, torch.int32, (sc, v + 1)),
            (state.term_counts, torch.int32, (t, v + 1)),
            (state.term_owners, torch.int32, (t, v + 1)),
            (pod_ints, torch.int32, (b, r + 4 + 2 * sc + 3 * t)),
            (pod_floats, torch.float32, (b, t)),
        ]
        device = static.allocatable.device
        for tensor, dtype, shape in expected:
            if tensor.device != device or tensor.dtype != dtype \
                    or tuple(tensor.shape) != shape \
                    or not tensor.is_contiguous():
                raise ValueError(
                    f"scan kernel wants a contiguous {dtype} {shape} on "
                    f"{device}; got {tensor.dtype} {tuple(tensor.shape)} on "
                    f"{tensor.device}")
        if r < 2:
            raise ValueError("the scan needs the cpu and memory columns")
        prof = pod_ints[:, r + 2]
        if bool(((prof < 0) | (prof >= u)).any()):
            raise ValueError(f"pod profile index outside [0, {u})")
        for codes in (static.sc_codes, static.term_codes):
            if bool(((codes < 0) | (codes > v)).any()):
                raise ValueError(f"topology code outside [0, {v}]")

    @staticmethod
    def plan(static: ScanStatic, b: int, tables=None, cols=None,
             k=None) -> ScanPlan:
        """``scan_plan`` of the dims of ``static`` and ``b`` pod rows."""
        r, sc, t, _, v, n = _scan_dims(static)
        return scan_plan(r, sc, t, v, n, b, tables, cols, k)

    def launch(self, params: SolverParams, static: ScanStatic,
               state: ScanState, pod_ints: torch.Tensor,
               pod_floats: torch.Tensor, plan: ScanPlan) -> torch.Tensor:
        """Launch on checked inputs (``check``) with ``plan``, on the
        current stream, without synchronising; ``state`` is updated in
        place. Raises on a refused launch."""
        lib = self._load()
        r, sc, t, u, v, n = _scan_dims(static)
        b = pod_ints.shape[0]
        device = state.pod_count.device
        assign = torch.empty(b, dtype=torch.int32, device=device)
        scratch = None
        if not plan.cols_in_smem:
            scratch = torch.empty(scan_col_words(sc, t, plan.k * plan.threads),
                                  dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        first = not self.launched
        t0 = time.monotonic()
        ptrs = [x.data_ptr() for x in (pod_ints, pod_floats, *static, *state,
                                       assign)]
        ptrs.append(None if scratch is None else scratch.data_ptr())
        err = lib.ktt_solve_scan_launch(
            *ptrs, r, sc, t, u, v, n, b, plan.k, plan.threads, plan.chunk,
            int(plan.tables_in_smem), int(plan.cols_in_smem),
            plan.smem_bytes, *params.as_tuple(), stream)
        if err != 0:
            raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
        self.launches += 1
        if first:
            self.launched = True
            self.note_compile("first launch scan", time.monotonic() - t0)
        return assign

    def __call__(self, params: SolverParams, static: ScanStatic,
                 state: ScanState, pod_ints: torch.Tensor,
                 pod_floats: torch.Tensor, tables=None, cols=None,
                 k=None) -> torch.Tensor:
        """Check, plan (``tables``, ``cols``, ``k``: see ``scan_plan``)
        and launch."""
        self.check(static, state, pod_ints, pod_floats)
        return self.launch(params, static, state, pod_ints, pod_floats,
                           self.plan(static, pod_ints.shape[0], tables,
                                     cols, k))


scan_kernel = ScanKernel()
_whatif_streams = {}


def solve_packed(params: SolverParams, static: ScanStatic, state: ScanState,
                 pod_ints: torch.Tensor, pod_floats: torch.Tensor
                 ) -> torch.Tensor:
    """One scan over a packed pod stream: the plain loop on CPU tensors,
    the kernel on CUDA tensors."""
    dev = static.allocatable.device
    if dev.type == "cpu":
        return solve_scan_plain(params, static, state, pod_ints, pod_floats)
    if dev.type == "cuda":
        return scan_kernel(params, static, state, pod_ints, pod_floats)
    raise ValueError(f"no scan for device {dev}")


def whatif_overrides(cluster, batch, deprioritized_cols=(),
                     disabled_cols=()):
    """(static scores, node validity) of a what-if, None where unchanged:
    ``deprioritized_cols`` lowers columns' static scores by
    ``VIRTUAL_NODE_PENALTY`` (a list) or by each column's own penalty (a
    mapping ``{col: penalty}``), in f32; ``disabled_cols`` removes
    columns from the solve."""
    scores = node_valid = None
    if len(deprioritized_cols):
        scores = np.array(batch.static_scores, dtype=np.float32, copy=True)
        if hasattr(deprioritized_cols, "items"):
            for col, penalty in deprioritized_cols.items():
                scores[:, int(col)] -= np.float32(penalty)
        else:
            cols = np.asarray(list(deprioritized_cols), dtype=np.int64)
            scores[:, cols] -= VIRTUAL_NODE_PENALTY
    if len(disabled_cols):
        node_valid = np.zeros(cluster.allocatable.shape[0], dtype=bool)
        node_valid[: cluster.num_real_nodes] = True
        node_valid[np.asarray(list(disabled_cols), dtype=np.int64)] = False
    return scores, node_valid


def scan_inputs(cluster, batch, device, static_scores=None, node_valid=None
                ) -> Tuple[ScanStatic, ScanState, torch.Tensor, torch.Tensor]:
    """(static, state, pod ints, pod floats) of an encoded batch on
    ``device``. Batches with shared-volume slots are refused: the scan
    has no attach planes (nor has the reference's)."""
    if batch.pod_sv is not None:
        raise ValueError("the scan has no shared-volume planes")
    ints, floats = pack_podin(batch)
    return (build_static(cluster, batch, device, static_scores, node_valid),
            build_state(cluster, batch, device),
            _tensor(ints, np.int32, device),
            _tensor(floats, np.float32, device))


def _run(params: SolverParams, cluster, batch, device, static_scores=None,
         node_valid=None) -> np.ndarray:
    """Upload and solve on ``device`` (on the card, on the what-if stream,
    off the batch loop's); the assignments on the host."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return solve_packed(params, *scan_inputs(
            cluster, batch, dev, static_scores, node_valid)).numpy()
    stream = _whatif_streams.get(dev)
    if stream is None:
        stream = _whatif_streams.setdefault(dev, torch.cuda.Stream(dev))
    with torch.cuda.stream(stream):
        assign = solve_packed(params, *scan_inputs(
            cluster, batch, dev, static_scores, node_valid))
        return assign.cpu().numpy()


def solve_scan(cluster, batch, params: SolverParams = SolverParams(),
               device=None) -> np.ndarray:
    """The scan over an encoded batch on ``device`` (the card unless
    "cpu"). Returns the assignment of each pod row [B], -1 where no node
    is feasible or the row is padding."""
    return _run(params, cluster, batch, device)


def solve_whatif(cluster, batch, params: SolverParams = SolverParams(),
                 deprioritized_cols=(), disabled_cols=(), device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The scan with the what-if's column overrides
    (``whatif_overrides``), for the cluster autoscaler. Returns
    ``(assignments [num_real_pods], pods assigned per column [N])``: one
    batched solve answers for every pending pod at once."""
    scores, node_valid = whatif_overrides(cluster, batch, deprioritized_cols,
                                          disabled_cols)
    a = _run(params, cluster, batch, device, scores, node_valid)
    a = a[: batch.num_real_pods]
    counts = np.bincount(a[a >= 0], minlength=cluster.allocatable.shape[0])
    return a, counts
