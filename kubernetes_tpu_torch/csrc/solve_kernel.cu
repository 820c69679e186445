// Batch scheduling solve for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel kubernetes_tpu/ops/pallas_solver.py::_kernel
// (built by _get_call, run by _run, used by PallasBackend): the whole batch's
// sequential pod loop in one launch. For each pod in queue order, every node
// column is checked (validity, pod-count cap, resource fit, static profile
// mask, hard topology spread against the minimum over the profile's eligible
// domain, existing and own anti-affinity, required affinity with the
// first-pod rule) and scored (balanced and least allocation, soft spread
// 100/(1+count), preferred term weights, static score); the best node, lowest
// index on ties, takes the pod, and the state planes are updated before the
// next pod reads them.
//
// Layout (see ops/planes.py): flat [C, N] planes, column j = node j.
//   static ints  alloc[R] | max_pods | masks[U] | sc_codes[SC] |
//                sc_domain[U*SC] | term_codes[T] | node_valid
//   static f32   scores[U]
//   state        requested[R] | nonzero[2] | pod_count | sc_counts[SC] |
//                term_counts[T] | term_owners[T] | sv_attached[SV] |
//                totals (first T columns)
//   pod ints     [B, R+4+2*SC+3*T (+2 when SV > 0)] rows of pack_podin;
//                pod floats [B, T]
// SC, T, U and SV are runtime loop bounds, so no constraint space is too wide.
//
// Shared volumes (SV > 0; the sv part of the reference's
// pallas_solver.py::_xla_planes_solve, which the JAX package runs for such
// epochs since its Pallas kernel has no sv planes): row s of sv_attached is 1
// on the nodes the shared CSI volume of slot s is attached to, and a pod's last
// two columns are its slot (SV: none) and its volume driver's attach-limit
// resource column. Such a pod needs one more attachment only where its volume
// is not attached yet: the fit gains requested[col] + req[col] + (1 -
// attached) <= alloc[col], and the winner's column gains the demand and is
// marked attached. Only the thread that owns a column reads or writes that
// column of an sv row, in every kernel, so the rows need no fence. The
// cluster kernel leaves the sv rows in global memory (at SV = 512 over 1,024
// columns they are 2 MB, which L2 holds) and touches them at L2 (__ldcg,
// __stcg: the kernel writes them), one row a pod, the one its slot names; its
// shared memory grows only by the pod chunks' two columns. The wide kernel
// carries them the same way, for sv epochs past the cluster's shared memory
// (the slot kernel takes no sv epoch, as the reference's sparse scan). Both
// dense kernels are templates on kSv: the launch takes the instance with the
// sv code only for an epoch with slots, so the others run no sv code at all
// (with it compiled in, the cluster kernel took 3-6% longer on the
// SchedulingBasic batch on an H100; PERF.md).
//
// What bounds it on this card: latency. The work is B*N pod-node checks of
// a few tens of operations each, over planes of a few hundred KB, but the
// pods are sequential (pod i+1 sees pod i's commit), so only the node axis
// is parallel and every pod pays the latency of its plane reads and of one
// reduction over all N columns. The TPU kernel keeps the whole state in VMEM
// across its sequential grid; a pod step there touches on-chip memory only.
// On an H100 the cluster kernel below spends about 2.1 us a pod whatever the
// width (PERF.md): the per-pod chain of barriers, shuffles and shared-memory
// round trips, not the columns, is what remains.
//
// Three kernels, picked per batch by the wrapper's launch plan (ops/solve.py,
// plan_launch): the cluster kernel whenever its shared-memory layout fits one
// block's 227 KB; else the slot kernel when every pod of the batch references
// at most 8 terms (the slot stream, ops/slots.py), the epoch has no sv slots
// and its cache holds the term lines of one pod; else the wide kernel. The
// sharded tier (kubernetes_tpu_torch/parallel/sharded.py) runs the sharded
// kernel below on every batch, and the feasibility counts kernel for
// solve_scan_sharded.
//
// solve_cluster_kernel, the main path. The node axis is spread over a
// thread-block cluster of up to 16 blocks (one per SM); block q owns columns
// [q*cpb, (q+1)*cpb) and, at most 512 threads a block, a thread owns one or a
// few of them. Each block holds its slice of every state row (loaded once
// with cp.async, written back once at the end) and of the static rows each
// pod reads (alloc, max_pods, node_valid, sc_codes, term_codes, and the U
// profile masks and static scores) in shared memory for the whole launch.
// The profiles' eligible-domain rows (U*SC of them, too many to hold) go
// through the read-only path (__ldg). Pod rows are staged 32 at a time,
// double-buffered with cp.async, and each pod's uniform facts (its active
// hard and soft constraints, its filter, affinity, preference and commit
// terms) are built once per chunk as index lists in shared memory, so a
// column loops over only what the pod uses. Across the cluster, reductions
// go over distributed shared memory: each block reduces its slice (warp
// shuffles, then the block), writes its candidate into a slot in every
// block's shared memory, and arrives on the cluster barrier; after the wait
// every block reduces the candidates itself, so one barrier per exchange
// suffices. Slots alternate by parity so an exchange's writes never race the
// previous exchange's reads. A pod with hard spread exchanges the vector of
// its constraints' domain minima first, with the barrier split: arrive,
// filter and score every column, then wait and apply only the skew check.
// A pod costs one cluster barrier (two with hard spread). The commit is
// local: each block updates its own columns, reading the winner's codes from
// the static plane by one broadcast load, and keeps its own copy of the
// per-term totals.
//
// solve_slots_kernel: the cluster kernel for wide term axes. Replaces the
// reference's sparse scan (pallas_solver.py::_xla_planes_solve_sparse, which
// the JAX package runs instead of its Pallas kernel when T >= 12 and the batch
// packs into slots): each pod carries at most K = 8 term slots (index, flags:
// matched = bit 0, own affinity = bit 1, own anti-affinity = bit 2, and its
// preferred weight), so a pod's term work is O(K) rows, not O(T). The cluster
// kernel's structure is kept: node axis over the cluster, each block's slice
// of the non-term state rows and of the static rows in shared memory, fact
// lists built once a chunk (from the slot flags and weights), one cluster
// barrier a pod (two with hard spread), local commits, a per-block copy of
// the term totals. The term rows (term_counts, term_owners, term_codes: 3*T
// rows, 6.1 MB at T = 100 over 5,120 columns) do not fit beside them, so each
// block keeps a cache of term lines in the shared memory the rest leaves, as
// many as fit and at most T, keyed by term index: a line is one term's owners,
// counts and codes rows at the block's columns (3,840 B at 320 columns; 49
// lines at T = 100 over 5,120 columns). Pods are staged by cp.async three
// chunks deep and run in windows: at each window's start warp 0 plans the
// next one, taking pods (four to 32 a warp step, by how many slots they use)
// while the terms it lists beside the running window's still fit the lines,
// so a window is as long as the data allows; a term keeps its line if
// resident, else it takes the clock's next line that neither window needs.
// While the running window's pods run, every thread writes the evicted
// lines' owners and counts back at L2 (__stcg; the codes are static) and
// copies the missing terms' rows in (cp.async.cg, 16 bytes a copy). Filters,
// the preferred sum and the commits read and write resident lines only. A
// window writes only lines it listed, so no line is written while it is
// copied in; a block's columns are touched only by its own threads, so no
// fence across blocks is needed. The plan (ops/solve.py::slots_candidate)
// stages the most pods, up to 32, that leave the cache the lines of a
// window of one pod (min(T, 8)). Where the lines hold two such windows (up
// to 10,240 columns at T = 100) the next window's first pod always fits
// beside the running one; where they do not (8 lines at 20,480 columns), a
// window whose first pod does not fit is planned again once the running
// window is done, its copies then not overlapped. The
// codes ride in the line because the cache takes most of the SM's shared
// memory and so most of its L1, where the read-only path kept them (two-row
// lines ran slower on the card). Bound, as the cluster kernel, by the
// per-pod latency chain, with no L2 round trip on it but the winner's code;
// each window adds its plan and two barriers (PERF.md).
//
// solve_wide_kernel: the slot kernel's structure over the dense pod stream,
// for the batches the other two do not take: a shape past the cluster's
// shared memory with a pod of more than 8 term references, or with sv slots,
// or a node axis too wide for any slice (N = 65,536). The reference runs its
// dense XLA scan there (pallas_solver.py::_xla_planes_solve, from
// XlaPlanesBackend.solve_lazy). Node axis over the cluster, one barrier a pod
// (two with hard spread), local commits, a per-block copy of the totals; the
// term rows and the sv rows at L2, each column read and written only by the
// thread that owns it. The layout is tiered by the plan (wide_layout): each
// block's slice of the non-term state rows and of the static rows a pod reads
// lives in shared memory when it fits (kSlices), else those rows too are read
// at L2 by the owning thread (__ldcg for the state, __ldg for the static
// rows). Pod rows (R+4+2*SC+3*T ints and T weights, about 1.6 KB at T = 100)
// are staged by cp.async in double-buffered chunks the plan sizes to what is
// left (at least one pod); past the point where one pod's rows fit (chunk 0)
// each pod's row is read where it lies, by uniform loads. Each chunk's facts
// are built once, a warp a pod, by ballots over the term axis: the pod's
// hard, soft and domain-commit constraints and one list of its term
// references (term << 5 | what it does: filter on owners, filter on counts,
// required affinity, preferred weight, commit), in increasing term order. A
// column then visits only those references, never T: at T = 100 a pod of the
// anti-affinity row references 1-13 terms. One pass over the references
// reads each term's counts once for the anti-affinity filter, the affinity
// filter and the preferred sum, which it adds in term order from 0.0, as the
// reference; a reference without a weight adds nothing, so skipping it is
// exact. Bound, as the slot kernel, by the per-pod latency chain (PERF.md).
//
// solve_sharded_kernel: the same solve with the node axis over S shards.
// Replaces the reference's mesh tier, kubernetes_tpu/parallel/sharded.py::
// _build_solve (a shard_map of lax.scan over _step: per pod each device
// filters and scores its node shard, one all_gather carries every shard's
// best score, its lowest global index at that score and that column's codes,
// and every device resolves the winner from the gathered rows; a pmin of the
// hard-spread domain minima first, for a batch with a hard constraint). One
// card stands in for the mesh: the wide kernel's body (wide_solve) runs each
// shard on its columns [s*N/S, (s+1)*N/S), and each shard keeps its own copy
// of the per-term totals ([S, T], outside the planes, whose totals row stays
// as it was, as in the reference). The plan's cut picks one of two routes.
// Where S divides the cluster size (16, or 8 on a card that admits no 16),
// every shard is a group of g blocks of one cluster, shard s on blocks [s*g,
// (s+1)*g), and the all_gather is the cluster's own exchange: each block
// writes its best (score, index) into every block's slots through
// distributed shared memory before the cluster barrier each pod pays anyway,
// and every block takes the best of all the slots (the higher score, then
// the lower index: a total order, so the best of every shard's best, as the
// reference resolves its gathered rows). The pmin is the body's round of
// domain minima in distributed shared memory, which now spans every shard's
// blocks, taken by the reference's rule (the mesh's minimum where the
// profile has an eligible domain value at all, else 0). The winner's codes
// come from the static planes, the whole mesh being on this card; every
// block of a shard keeps the shard's totals, which its first block writes
// back once. No fence, flag or poll at GPU scope is left on this route: a
// pod costs the wide kernel's chain, whatever S. Where S divides no cluster
// size (or is wider than one), the global route: shard s is cluster s of one
// launch, and the all_gather is an exchange through global memory: the
// cluster's first block writes the shard's payload (score, index, the SC+T
// codes of that column) into a slot of the pod's parity and raises the
// shard's flag to the pod's sequence number with a release store at GPU
// scope; every block polls the S flags with acquire loads and resolves the
// winner as the reference does, the commit reading the winner's codes from
// the winning payload. The pmin is a second such round before the skew
// check, compiled only into the instance for batches with a hard constraint
// (kHard). The workspace is zeroed before every launch, so no launch reads
// another's flags. A poll is bounded: past 2 s it sets an error word that
// the wrapper raises on, and every other poll gives up at once. The launch
// refuses a shape whose S clusters the card cannot hold at once
// (cudaOccupancyMaxActiveClusters). Bound by the per-pod chain of the wide
// kernel plus the flag's round trip through L2, one a pod, two with hard
// spread. A later multi-card build places the slots in peer memory
// (ROADMAP).
//
// feasible_counts_kernel: the reference's _batched_static_feasibility
// (sharded.py, a psum over the node axis): per pod the nodes that are valid,
// in its profile's static mask and fit its requests. The count does not
// depend on the mesh (a sum over the shards' column slices is a sum over all
// N columns), so one launch covers every column, whatever S and the batch
// axis are. A cluster of up to 8 blocks splits the columns; each block copies
// its slice's alloc rows into shared memory by cp.async and folds each
// profile's mask with the validity row into one bit word per 32 columns,
// once. As many clusters as the card holds then take tiles of 32 pods
// (requests and profile), up to 16 tiles a chunk, double-buffered by
// cp.async: the next chunk is in flight while this one is counted. A lane
// owns a pod of the tile, its requests in registers; a warp walks its words
// of the slice, four columns a broadcast read of each alloc row, and each
// lane adds its pod's fits, masked by its profile's word, to its running
// count. The warps' sums meet in shared memory, the blocks' in distributed
// shared memory after one cluster barrier a chunk, and rank 0 writes each
// pod's count once: no fill, no atomics, integer sums (exact in any order).
// Bound by the per pod x column compare (R + 2 integer operations); the
// static rows are read once a block.
//
// Exactness: built with --fmad=false and IEEE division; the score is summed
// in the reference's order, and the (higher score, lower index) rule is
// associative and commutative, so assignments match the reference bit for
// bit in any reduction order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kSlots = 8;  // term slots a pod, ops/slots.py::SPARSE_K
constexpr int kMatched = 1, kOwnAff = 2, kOwnAnti = 4;  // slot flag bits
constexpr int kBig = 1 << 30;
constexpr int kSmemLimit = 232448;  // one block's shared memory on Hopper
constexpr float kFoundThreshold = -5e29f;  // NEG_INF / 2

struct Dims {
  int r, sc, t, u, v, sv, n, b;
};

// Int columns of a dense pod-stream row: the slot and the attach column
// follow the terms when the epoch has shared-volume slots.
__host__ __device__ inline int pod_width(const Dims& d) {
  return d.r + 4 + 2 * d.sc + 3 * d.t + (d.sv > 0 ? 2 : 0);
}

struct Weights {
  float balanced, least, spread, affinity, stat;
};

// The cluster kernel's launch plan, as ops/solve.py::plan_launch made it.
struct Plan {
  int cluster, threads, cpb, chunk;
};

// Shared-memory layout of the cluster kernel, in 4-byte words. The wrapper's
// plan computes the same total (ops/solve.py::cluster_smem_bytes); the launch
// refuses a plan whose byte count differs.
struct Layout {
  int state, stat, score, totals, meta, pod_i, pod_f, facts, wmin, wbest, slot_min,
      slot_best, xwin, words;
};

__host__ __device__ inline int fact_stride(int sc, int t) { return 8 + 3 * sc + 4 * t; }

__host__ __device__ inline Layout cluster_layout(const Dims& d, const Plan& p) {
  Layout l{};
  int w = 0;
  const int width = pod_width(d);
  l.state = w;
  w += (d.r + 3 + d.sc + 2 * d.t) * p.cpb;  // every state row but sv and totals
  l.stat = w;
  w += (d.r + 2 + d.sc + d.t + 2 * d.u) * p.cpb;  // + masks, static scores
  l.score = w;
  w += p.cpb;
  l.totals = w;
  w += d.t;
  l.meta = w;
  w += 2 * d.sc;
  l.pod_i = w;
  w += 2 * p.chunk * width;
  l.pod_f = w;
  w += 2 * p.chunk * d.t;
  l.facts = w;
  w += p.chunk * fact_stride(d.sc, d.t);
  l.wmin = w;
  w += d.sc * (p.threads / 32);
  l.wbest = w;
  w += 2 * (p.threads / 32);
  l.slot_min = w;
  w += 2 * p.cluster * d.sc;
  l.slot_best = w;
  w += 2 * 2 * p.cluster;
  l.words = w;
  return l;
}

// Int columns of a slot-stream row: base | slot index[K] | slot flags[K].
__host__ __device__ inline int slot_width(int r, int sc) { return r + 4 + 2 * sc + 2 * kSlots; }

// The slot kernel's facts: the counts, then hard, soft and domain-commit
// constraint lists and the filter-and-commit, affinity and preference slot
// lists.
__host__ __device__ inline int slot_fact_stride(int sc) { return 8 + 3 * sc + 3 * kSlots; }

// The slot kernel stages pods three chunks deep: the chunk that runs, the
// next one (where the next window of pods may start) and the one after (in
// flight).
constexpr int kPodBufs = 3;
// A cache line: a term's owners, counts and codes rows at the block's columns.
constexpr int kLineRows = 3;

// The slot kernel's term-row cache, in 4-byte words after the rest of its
// layout: the line holding each term (-1: none) and the last window whose
// plan listed it; one plan's missing terms and its jobs (their count, the
// window's end, then a line and the term it evicts, a job); then, 16-byte
// aligned, `cap` lines of kLineRows rows, the term each line holds and the
// last window that needs it. `need`: min(T, K), the lines a window of one
// pod may list; the lines are as many as fit one block's shared memory, at
// most T, and never fewer than `need` (then the layout is past the limit,
// so the plan does not take it).
struct Cache {
  int slot, mark, miss, jobs, rows, key, stamp, cap, need;
};

// Shared-memory layout of the slot kernel, in 4-byte words: the cluster
// kernel's without the term rows, three pod chunks, and the term-row cache
// (ops/solve.py::slots_smem_bytes).
__host__ __device__ inline Layout slots_layout(const Dims& d, const Plan& p,
                                               Cache* cache = nullptr) {
  Layout l{};
  int w = 0;
  l.state = w;
  w += (d.r + 3 + d.sc) * p.cpb;  // requested, nonzero, pod_count, sc_counts
  l.stat = w;
  w += (d.r + 2 + d.sc + 2 * d.u) * p.cpb;  // alloc, max_pods, valid, sc_codes, masks, scores
  l.score = w;
  w += p.cpb;
  l.totals = w;
  w += d.t;
  l.meta = w;
  w += 2 * d.sc;
  l.pod_i = w;
  w += kPodBufs * p.chunk * slot_width(d.r, d.sc);
  l.pod_f = w;
  w += kPodBufs * p.chunk * kSlots;
  l.facts = w;
  w += p.chunk * slot_fact_stride(d.sc);
  l.wmin = w;
  w += d.sc * (p.threads / 32);
  l.wbest = w;
  w += 2 * (p.threads / 32);
  l.slot_min = w;
  w += 2 * p.cluster * d.sc;
  l.slot_best = w;
  w += 2 * 2 * p.cluster;
  Cache c{};
  c.slot = w;
  w += d.t;
  c.mark = w;
  w += d.t;
  c.miss = w;
  w += p.chunk * kSlots;
  c.jobs = w;
  w += 2 + 2 * p.chunk * kSlots;
  w = (w + 3) & ~3;
  const int line = kLineRows * p.cpb + 2;
  const int fit = (kSmemLimit / (int)sizeof(int) - w) / line;
  c.need = d.t < kSlots ? d.t : kSlots;
  c.cap = fit < d.t ? fit : d.t;
  if (c.cap < c.need) c.cap = c.need;
  c.rows = w;
  w += kLineRows * p.cpb * c.cap;
  c.key = w;
  w += c.cap;
  c.stamp = w;
  w += c.cap;
  l.words = w;
  if (cache != nullptr) *cache = c;
  return l;
}

// Per-pod facts: eight counts, then the index lists, each in increasing
// constraint or term order (the reference's summation order).
enum { kNHard, kNSoft, kNScc, kNTf, kNAff, kNPref, kNTc, kSelfAll, kHead };

// The wide kernel's facts: the same eight-word head (kNTf counts the term
// references), the hard, soft and domain-commit constraint lists, then one
// list of the pod's term references, each (term << kRefShift) | what the
// term does for the pod.
enum {
  kRefOwners = 1,   // matched: the filter wants no owner in the domain
  kRefCounts = 2,   // own anti-affinity: the filter wants no match there
  kRefAff = 4,      // own required affinity
  kRefPref = 8,     // a preferred weight
  kRefCommit = 16,  // matched or own anti-affinity: counted at the commit
};
constexpr int kRefShift = 5;

__host__ __device__ inline int wide_fact_stride(int sc, int t) { return kHead + 3 * sc + t; }

// Shared-memory layout of the wide kernel, in 4-byte words: with `slices`,
// the slot kernel's slices of the non-term state and static rows; then the
// score row, totals, sc_meta, two chunks of dense pod rows and weights (none
// at chunk 0: rows read in place), one chunk's facts (one pod's at chunk 0),
// the warp slots and the exchange slots (ops/solve.py::wide_smem_bytes).
__host__ __device__ inline Layout wide_layout(const Dims& d, const Plan& p, bool slices) {
  Layout l{};
  int w = 0;
  l.state = w;
  if (slices) w += (d.r + 3 + d.sc) * p.cpb;  // requested, nonzero, pod_count, sc_counts
  l.stat = w;
  if (slices) w += (d.r + 2 + d.sc + 2 * d.u) * p.cpb;  // alloc, max_pods, valid, sc_codes, masks, scores
  l.score = w;
  w += p.cpb;
  l.totals = w;
  w += d.t;
  l.meta = w;
  w += 2 * d.sc;
  l.pod_i = w;
  w += 2 * p.chunk * pod_width(d);
  l.pod_f = w;
  w += 2 * p.chunk * d.t;
  l.facts = w;
  w += (p.chunk > 0 ? p.chunk : 1) * wide_fact_stride(d.sc, d.t);
  l.wmin = w;
  w += d.sc * (p.threads / 32);
  l.wbest = w;
  w += 2 * (p.threads / 32);
  l.slot_min = w;
  w += 2 * p.cluster * d.sc;
  l.slot_best = w;
  w += 2 * 2 * p.cluster;
  l.words = w;
  return l;
}

// The plan's tier: the slices live in shared memory exactly when that
// layout fits one block's (the wrapper's plan follows the same rule).
__host__ __device__ inline bool wide_slices(const Dims& d, const Plan& p) {
  return (long)wide_layout(d, p, true).words * (long)sizeof(int) <= kSmemLimit;
}

// The sharded kernel's layout: the wide kernel's and the mesh's winner of
// each pod (score, index), two parities (ops/solve.py::sharded_smem_bytes).
__host__ __device__ inline Layout sharded_layout(const Dims& d, const Plan& p, bool slices) {
  Layout l = wide_layout(d, p, slices);
  l.xwin = l.words;
  l.words += 2 * 2;
  return l;
}

__host__ __device__ inline bool sharded_slices(const Dims& d, const Plan& p) {
  return (long)sharded_layout(d, p, true).words * (long)sizeof(int) <= kSmemLimit;
}

// The sharded launch: node shards, columns a shard, the static domain
// existence [U, SC], the shards' totals [S, T] and the exchange workspace
// (zeroed before every launch; sharded_workspace lays it out).
struct Shard {
  int shards, nl;
  const int* has_dom;
  int* totals;
  int* ws;
};

// The exchange workspace, in 4-byte words: per parity and shard a flag of
// the best round and one of the domain-minima round, each on a 128-byte
// line of its own; the error word; the payloads ([2][S][2+SC+T]: score bits,
// the lowest global index at that score, that column's SC+T codes); the
// domain minima ([2][S][SC]).
constexpr int kFlagStride = 32;
struct Exchange {
  int flag_best, flag_min, err, xch, xmin, xw, words;
};

__host__ __device__ inline Exchange sharded_workspace(int shards, int sc, int t) {
  Exchange x;
  x.flag_best = 0;
  x.flag_min = 2 * shards * kFlagStride;
  x.err = 4 * shards * kFlagStride;
  x.xch = x.err + kFlagStride;
  x.xw = 2 + sc + t;
  x.xmin = x.xch + 2 * shards * x.xw;
  x.words = x.xmin + 2 * shards * sc;
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

// (score, index) pair: the higher score wins, the lower index on equal scores.
__device__ __forceinline__ void better(float& s, int& j, float os, int oj) {
  if (os > s || (os == s && oj < j)) {
    s = os;
    j = oj;
  }
}

__device__ __forceinline__ void warp_best(float& s, int& j) {
  for (int o = 16; o > 0; o >>= 1)
    better(s, j, __shfl_down_sync(0xffffffffu, s, o), __shfl_down_sync(0xffffffffu, j, o));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// 16 bytes at L2 (.cg: not through L1, which may hold a line of a row the
// kernel has since written back)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A shard's wait for another's flag: the longest a poll spins (about
// 10^5 pods' exchanges) before it gives up, sets the error word and
// returns false, and the error codes the wrapper raises on.
constexpr unsigned long long kPollNs = 2000000000ull;
enum { kErrPoll = 1, kErrHard = 2 };

// Wait until *flag == seq (acquire). False when the wait ran out (the error
// word is set) or another wait already had.
__device__ bool poll_flag(const int* flag, int seq, int* err) {
  unsigned long long t0 = 0;
  for (unsigned it = 1;; ++it) {
    if (ld_acquire(flag) == seq) return true;
    if ((it & 255u) == 0) {
      if (__ldcg(err) != 0) return false;
      const unsigned long long now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kPollNs) {
        atomicCAS(err, 0, kErrPoll);
        return false;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster kernel (see the note at the top). kSv: the epoch has
// shared-volume slots; the instance without them compiles no sv code, so
// the main path runs as it did before the planes existed.
template <bool kSv>
__global__ void __launch_bounds__(kClusterThreads, 1)
solve_cluster_kernel(const int* __restrict__ sc_meta, const int* __restrict__ pod_ints,
                     const float* __restrict__ pod_floats, const int* __restrict__ sta,
                     const float* __restrict__ sta_f, int* __restrict__ st,
                     int* __restrict__ assign, Dims d, Weights w, Plan pl) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nc = pl.cluster;
  const Layout L = cluster_layout(d, pl);

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int r = d.r, sc = d.sc, t = d.t, u = d.u, v = d.v, n = d.n;
  const size_t N = (size_t)n;
  const int cpb = pl.cpb, chunk = pl.chunk;
  const int lo = rank * cpb;
  const int cols = max(0, min(cpb, n - lo));

  // global static plane rows
  const int s_alloc = 0, s_max_pods = r, s_masks = r + 1, s_sc_codes = r + 1 + u;
  const int s_sc_domain = s_sc_codes + sc, s_term_codes = s_sc_domain + u * sc;
  const int s_node_valid = s_term_codes + t;
  // state plane rows (global and shared alike, sv and totals excepted:
  // the sv rows stay in global memory, L2)
  const int d_req = 0, d_nz = r, d_pod_count = r + 2, d_sc_counts = r + 3;
  const int d_term_counts = d_sc_counts + sc, d_term_owners = d_term_counts + t;
  const int d_sv = d_term_owners + t, d_totals = d_sv + (kSv ? d.sv : 0);
  // shared static rows: alloc[R] | max_pods | node_valid | sc_codes[SC] |
  // term_codes[T] | masks[U] | static scores[U] (f32)
  const int a_max_pods = r, a_valid = r + 1, a_sc_codes = r + 2, a_term_codes = r + 2 + sc;
  const int a_masks = a_term_codes + t, a_scores = a_masks + u;
  const int n_int_stat = a_scores;
  // pod stream columns
  const int c_nz = r, c_profile = r + 2, c_valid = r + 3, c_pod_sc = r + 4;
  const int c_sc_match = c_pod_sc + sc, c_match_by = c_sc_match + sc;
  const int c_own_aff = c_match_by + t, c_own_anti = c_own_aff + t;
  const int c_sv = c_own_anti + t;
  const int width = c_sv + (kSv ? 2 : 0);  // pod_width(d): kSv is d.sv > 0
  const int fstride = fact_stride(sc, t);

  int* s_state = smem + L.state;
  int* s_stat = smem + L.stat;
  float* s_score = reinterpret_cast<float*>(smem + L.score);
  int* totals = smem + L.totals;
  int* meta = smem + L.meta;
  int* pod_i = smem + L.pod_i;
  float* pod_f = reinterpret_cast<float*>(smem + L.pod_f);
  int* facts = smem + L.facts;
  int* wmin = smem + L.wmin;
  float* wbest_s = reinterpret_cast<float*>(smem + L.wbest);
  int* wbest_j = smem + L.wbest + nwarps;
  int* slot_min = smem + L.slot_min;  // [2][cluster][SC]
  float* slot_s = reinterpret_cast<float*>(smem + L.slot_best);  // [2][cluster]
  int* slot_j = smem + L.slot_best + 2 * nc;                    // [2][cluster]

  // the block's slice of the planes, once
  for (int row = 0; row < d_sv; ++row)
    for (int c = tid; c < cols; c += nt)
      cp_async4(s_state + row * cpb + c, st + row * N + lo + c);
  for (int row = 0; row < n_int_stat; ++row) {
    const int g = row < a_max_pods      ? s_alloc + row
                  : row == a_max_pods   ? s_max_pods
                  : row == a_valid      ? s_node_valid
                  : row < a_term_codes  ? s_sc_codes + (row - a_sc_codes)
                  : row < a_masks       ? s_term_codes + (row - a_term_codes)
                                        : s_masks + (row - a_masks);
    for (int c = tid; c < cols; c += nt) cp_async4(s_stat + row * cpb + c, sta + g * N + lo + c);
  }
  for (int k = 0; k < u; ++k)
    for (int c = tid; c < cols; c += nt)
      cp_async4(s_stat + (a_scores + k) * cpb + c, sta_f + k * N + lo + c);
  cp_async_commit();
  for (int k = tid; k < t; k += nt) totals[k] = st[d_totals * N + k];
  for (int k = tid; k < 2 * sc; k += nt) meta[k] = sc_meta[k];

  const int nchunks = (d.b + chunk - 1) / chunk;
  auto fetch = [&](int ch) {
    const int p0 = ch * chunk, np = min(chunk, d.b - p0), buf = ch & 1;
    int* di = pod_i + buf * chunk * width;
    const int* si = pod_ints + (size_t)p0 * width;
    for (int i = tid; i < np * width; i += nt) cp_async4(di + i, si + i);
    float* df = pod_f + buf * chunk * t;
    const float* sf = pod_floats + (size_t)p0 * t;
    for (int i = tid; i < np * t; i += nt) cp_async4(df + i, sf + i);
  };
  if (nchunks > 0) fetch(0);
  cp_async_commit();

  // every block of the cluster is running before any slot is written
  cluster_arrive();
  cluster_wait();

  int par_min = 0, par_best = 0;
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) fetch(ch + 1);
    cp_async_commit();
    cp_async_wait<1>();  // the slice and this chunk have landed
    __syncthreads();
    const int p0 = ch * chunk, np = min(chunk, d.b - p0), buf = ch & 1;
    const int* rows = pod_i + buf * chunk * width;
    const float* frows = pod_f + buf * chunk * t;

    for (int i = tid; i < np; i += nt) {  // each pod's uniform facts, once
      const int* row = rows + i * width;
      const float* wrow = frows + i * t;
      int* f = facts + i * fstride;
      int* hard = f + kHead;
      int* soft = hard + sc;
      int* scc = soft + sc;
      int* tf = scc + sc;
      int* aff = tf + t;
      int* pref = aff + t;
      int* tc = pref + t;
      int nh = 0, ns = 0, nscc = 0, ntf = 0, naff = 0, npref = 0, ntc = 0, self_all = 1;
      for (int k = 0; k < sc; ++k) {
        if (row[c_pod_sc + k] > 0) {
          if (meta[sc + k] > 0)
            hard[nh++] = k;
          else
            soft[ns++] = k;
        }
        if (row[c_sc_match + k] != 0) scc[nscc++] = k;
      }
      for (int k = 0; k < t; ++k) {
        const int matched = row[c_match_by + k], anti = row[c_own_anti + k];
        if (matched > 0 || anti > 0) tf[ntf++] = k;
        if (row[c_own_aff + k] > 0) {
          aff[naff++] = k;
          self_all = self_all && matched > 0;
        }
        if (wrow[k] != 0.0f) pref[npref++] = k;
        if (matched != 0 || anti != 0) tc[ntc++] = k;
      }
      f[kNHard] = nh;
      f[kNSoft] = ns;
      f[kNScc] = nscc;
      f[kNTf] = ntf;
      f[kNAff] = naff;
      f[kNPref] = npref;
      f[kNTc] = ntc;
      f[kSelfAll] = self_all;
    }
    __syncthreads();

    for (int i = 0; i < np; ++i) {
      const int p = p0 + i;
      const int* row = rows + i * width;
      const float* wrow = frows + i * t;
      if (row[c_valid] <= 0) {  // padding or inexpressible: no node, no commit
        if (rank == 0 && tid == 0) assign[p] = -1;
        continue;
      }
      const int* f = facts + i * fstride;
      const int nh = f[kNHard], ns = f[kNSoft], nscc = f[kNScc], ntf = f[kNTf];
      const int naff = f[kNAff], npref = f[kNPref], ntc = f[kNTc];
      const int* hard = f + kHead;
      const int* soft = hard + sc;
      const int* scc = soft + sc;
      const int* tf = scc + sc;
      const int* aff = tf + t;
      const int* pref = aff + t;
      const int* tc = pref + t;
      const int profile = row[c_profile];
      const int* mask_row = s_stat + (a_masks + profile) * cpb;
      const float* static_row = reinterpret_cast<const float*>(s_stat + (a_scores + profile) * cpb);
      // the pod's shared volume: its sv row (this block's columns, in L2,
      // read at L2 since the kernel writes it) and attach column
      const int slot = kSv ? row[c_sv] : 0, vcol = kSv ? row[c_sv + 1] : 0;
      int* att = kSv && slot < d.sv ? st + (size_t)(d_sv + slot) * N + lo : nullptr;

      // hard spread: this block's domain minima of every active constraint,
      // published to every block; the barrier's wait comes after the filter
      if (nh > 0) {
        for (int h = 0; h < nh; ++h) {
          const int k = hard[h];
          const int* dom = sta + (s_sc_domain + profile * sc + k) * N + lo;
          const int* counts = s_state + (d_sc_counts + k) * cpb;
          int m = kBig;
          for (int c = tid; c < cols; c += nt)
            if (__ldg(dom + c) > 0) m = min(m, counts[c]);
          m = warp_min(m);
          if (lane == 0) wmin[h * nwarps + warp] = m;
        }
        __syncthreads();
        for (int h = tid; h < nh; h += nt) {
          int m = kBig;
          for (int q = 0; q < nwarps; ++q) m = min(m, wmin[h * nwarps + q]);
          int* slot = slot_min + (par_min * nc + rank) * sc + h;
          for (int q = 0; q < nc; ++q) *cluster.map_shared_rank(slot, q) = m;
        }
        cluster_arrive();
      }
      // required affinity: the first pod of a group passes anywhere when no
      // pod matches any of its terms yet and it matches all of them itself
      bool need_aff = false;
      if (naff > 0) {
        if (nh == 0) __syncthreads();  // thread 0's totals of the last commit
        bool no_any = true;
        for (int x = 0; x < naff; ++x) no_any = no_any && totals[aff[x]] == 0;
        need_aff = !(no_any && f[kSelfAll]);
      }

      // filter (all but the skew check) and score; -inf marks infeasible.
      // The checks combine with & and the score is computed for every
      // column, so that a column's loads issue together, not one after
      // another behind short-circuits.
      for (int c = tid; c < cols; c += nt) {
        bool ok = (s_stat[a_valid * cpb + c] > 0) &
                  (s_state[d_pod_count * cpb + c] < s_stat[a_max_pods * cpb + c]) &
                  (mask_row[c] > 0);
        for (int k = 0; k < r; ++k)
          ok = ok & (s_state[(d_req + k) * cpb + c] + row[k] <= s_stat[k * cpb + c]);
        if (att != nullptr)
          ok = ok & (s_state[(d_req + vcol) * cpb + c] + row[vcol] + (1 - __ldcg(att + c)) <=
                     s_stat[vcol * cpb + c]);
        for (int x = 0; x < ntf; ++x) {
          const int k = tf[x];
          ok = ok & !(row[c_match_by + k] > 0 && s_state[(d_term_owners + k) * cpb + c] > 0) &
               !(row[c_own_anti + k] > 0 && s_state[(d_term_counts + k) * cpb + c] > 0);
        }
        for (int x = 0; need_aff && x < naff; ++x) {
          const int k = aff[x];
          ok = ok & (s_state[(d_term_counts + k) * cpb + c] > 0) &
               (s_stat[(a_term_codes + k) * cpb + c] < v);
        }
        for (int h = 0; h < nh; ++h) ok = ok & (s_stat[(a_sc_codes + hard[h]) * cpb + c] < v);
        const float alloc_cpu = (float)max(s_stat[c], 1);
        const float alloc_mem = (float)max(s_stat[cpb + c], 1);
        const float cpu = (float)(s_state[d_nz * cpb + c] + row[c_nz]) / alloc_cpu;
        const float mem = (float)(s_state[(d_nz + 1) * cpb + c] + row[c_nz + 1]) / alloc_mem;
        const bool over = cpu >= 1.0f || mem >= 1.0f;
        const float balanced = over ? 0.0f : (1.0f - fabsf(cpu - mem)) * 100.0f;
        const float least =
            (fminf(fmaxf(1.0f - cpu, 0.0f), 1.0f) + fminf(fmaxf(1.0f - mem, 0.0f), 1.0f)) * 50.0f;
        float spread = 0.0f;
        if (ns > 0) {
          float soft_sum = 0.0f;
          for (int x = 0; x < ns; ++x)
            soft_sum += (float)s_state[(d_sc_counts + soft[x]) * cpb + c];
          spread = 100.0f / (1.0f + soft_sum);
        }
        float pref_sum = 0.0f;
        for (int x = 0; x < npref; ++x) {
          const int k = pref[x];
          pref_sum += wrow[k] * (float)s_state[(d_term_counts + k) * cpb + c];
        }
        float s = w.balanced * balanced;
        s = s + w.least * least;
        s = s + w.spread * spread;
        s = s + w.affinity * pref_sum;
        s = s + w.stat * static_row[c];
        s_score[c] = ok ? s : -INFINITY;
      }

      // the skew check against the cluster's minima, and this block's best
      if (nh > 0) cluster_wait();
      const int* mins = slot_min + par_min * nc * sc;
      float best_s = -INFINITY;
      int best_j = INT_MAX;
      for (int c = tid; c < cols; c += nt) {
        const float s = s_score[c];
        if (s == -INFINITY) continue;
        bool ok = true;
        for (int h = 0; ok && h < nh; ++h) {
          const int k = hard[h];
          int m = kBig;
          for (int q = 0; q < nc; ++q) m = min(m, mins[q * sc + h]);
          m = m < kBig ? m : 0;  // 0 when the profile has no eligible domain
          ok = s_state[(d_sc_counts + k) * cpb + c] + row[c_sc_match + k] - m <= meta[k];
        }
        if (ok) better(best_s, best_j, s, lo + c);
      }
      warp_best(best_s, best_j);
      if (lane == 0) {
        wbest_s[warp] = best_s;
        wbest_j[warp] = best_j;
      }
      __syncthreads();
      if (warp == 0) {
        float s = -INFINITY;
        int j = INT_MAX;
        if (lane < nwarps) {
          s = wbest_s[lane];
          j = wbest_j[lane];
        }
        warp_best(s, j);
        s = __shfl_sync(0xffffffffu, s, 0);
        j = __shfl_sync(0xffffffffu, j, 0);
        if (lane < nc) {
          *cluster.map_shared_rank(slot_s + par_best * nc + rank, lane) = s;
          *cluster.map_shared_rank(slot_j + par_best * nc + rank, lane) = j;
        }
      }
      cluster_arrive();
      cluster_wait();
      best_s = -INFINITY;
      best_j = INT_MAX;
      for (int q = 0; q < nc; ++q) better(best_s, best_j, slot_s[par_best * nc + q], slot_j[par_best * nc + q]);
      par_best ^= 1;
      if (nh > 0) par_min ^= 1;
      if (best_j == INT_MAX || !(best_s > kFoundThreshold)) {
        if (rank == 0 && tid == 0) assign[p] = -1;
        continue;  // uniform: every block reduced the same candidates
      }

      // commit to node jc, each block on its own columns
      const int jc = best_j, cj = jc - lo;
      if (cj >= 0 && cj < cols && cj % nt == tid) {
        for (int k = 0; k < r; ++k) s_state[(d_req + k) * cpb + cj] += row[k];
        s_state[d_nz * cpb + cj] += row[c_nz];
        s_state[(d_nz + 1) * cpb + cj] += row[c_nz + 1];
        s_state[d_pod_count * cpb + cj] += 1;
        if (att != nullptr) {  // one more attachment where it was not attached
          s_state[(d_req + vcol) * cpb + cj] += 1 - __ldcg(att + cj);
          __stcg(att + cj, 1);
        }
      }
      for (int x = 0; x < nscc; ++x) {
        const int k = scc[x];
        const int inc = row[c_sc_match + k];
        const int code_j = __ldg(sta + (s_sc_codes + k) * N + jc);
        const int* codes = s_stat + (a_sc_codes + k) * cpb;
        int* counts = s_state + (d_sc_counts + k) * cpb;
        for (int c = tid; c < cols; c += nt)
          if (codes[c] == code_j) counts[c] += inc;
      }
      for (int x = 0; x < ntc; ++x) {
        const int k = tc[x];
        const int matched = row[c_match_by + k], anti = row[c_own_anti + k];
        const int code_j = __ldg(sta + (s_term_codes + k) * N + jc);
        const int* codes = s_stat + (a_term_codes + k) * cpb;
        int* tcounts = s_state + (d_term_counts + k) * cpb;
        int* towners = s_state + (d_term_owners + k) * cpb;
        for (int c = tid; c < cols; c += nt) {
          if (codes[c] != code_j) continue;
          tcounts[c] += matched;
          towners[c] += anti;
        }
        if (tid == 0 && code_j < v) totals[k] += matched;
      }
      if (rank == 0 && tid == 0) assign[p] = jc;
    }
    __syncthreads();  // the chunk's buffers are free for the next fetch
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int row = 0; row < d_sv; ++row)
    for (int c = tid; c < cols; c += nt) st[row * N + lo + c] = s_state[row * cpb + c];
  for (int c = tid; c < cols; c += nt) {
    const int j = lo + c;
    st[d_totals * N + j] = j < t ? totals[j] : 0;
  }
  // no block leaves while another may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// The slot kernel (see the note at the top). Pods come as the slot stream:
// [B, R+4+2*SC+2*K] ints (base | slot index | slot flags) and [B, K] weights.
__global__ void __launch_bounds__(kClusterThreads, 1)
solve_slots_kernel(const int* __restrict__ sc_meta, const int* __restrict__ pod_ints,
                   const float* __restrict__ pod_floats, const int* __restrict__ sta,
                   const float* __restrict__ sta_f, int* st, int* __restrict__ assign, Dims d,
                   Weights w, Plan pl) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nc = pl.cluster;
  Cache C;
  const Layout L = slots_layout(d, pl, &C);

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int r = d.r, sc = d.sc, t = d.t, u = d.u, v = d.v, n = d.n;
  const size_t N = (size_t)n;
  const int cpb = pl.cpb, chunk = pl.chunk;
  const int lo = rank * cpb;
  const int cols = max(0, min(cpb, n - lo));
  const int quads = cols / 4;  // a multiple of 32 columns: n % 128, cpb % 32

  // global static plane rows
  const int s_alloc = 0, s_max_pods = r, s_masks = r + 1, s_sc_codes = r + 1 + u;
  const int s_sc_domain = s_sc_codes + sc, s_term_codes = s_sc_domain + u * sc;
  const int s_node_valid = s_term_codes + t;
  // state plane rows; those before the term rows are held in shared memory
  const int d_req = 0, d_nz = r, d_pod_count = r + 2, d_sc_counts = r + 3;
  const int d_term_counts = d_sc_counts + sc, d_term_owners = d_term_counts + t;
  const int d_totals = d_term_owners + t;
  // shared static rows: alloc[R] | max_pods | node_valid | sc_codes[SC] |
  // masks[U] | static scores[U] (f32)
  const int a_max_pods = r, a_valid = r + 1, a_sc_codes = r + 2, a_masks = r + 2 + sc;
  const int a_scores = a_masks + u;
  // slot-stream columns
  const int c_nz = r, c_profile = r + 2, c_valid = r + 3, c_pod_sc = r + 4;
  const int c_sc_match = c_pod_sc + sc, c_idx = c_sc_match + sc, c_flags = c_idx + kSlots;
  const int width = c_flags + kSlots;
  const int fstride = slot_fact_stride(sc);

  // this block's columns of the term rows, in global memory: row k at k * N
  int* g_counts = st + d_term_counts * N + lo;
  int* g_owners = st + d_term_owners * N + lo;
  const int* g_codes = sta + s_term_codes * N + lo;

  int* s_state = smem + L.state;
  int* s_stat = smem + L.stat;
  float* s_score = reinterpret_cast<float*>(smem + L.score);
  int* totals = smem + L.totals;
  int* meta = smem + L.meta;
  int* pod_i = smem + L.pod_i;
  float* pod_f = reinterpret_cast<float*>(smem + L.pod_f);
  int* facts = smem + L.facts;
  int* wmin = smem + L.wmin;
  float* wbest_s = reinterpret_cast<float*>(smem + L.wbest);
  int* wbest_j = smem + L.wbest + nwarps;
  int* slot_min = smem + L.slot_min;  // [2][cluster][SC]
  float* slot_s = reinterpret_cast<float*>(smem + L.slot_best);  // [2][cluster]
  int* slot_j = smem + L.slot_best + 2 * nc;                    // [2][cluster]
  // the term-row cache: a line is owners | counts | codes, cpb words each
  int* cslot = smem + C.slot;    // [T] the line holding the term, -1: none
  int* cmark = smem + C.mark;    // [T] the last window whose plan listed it
  int* cmiss = smem + C.miss;    // [chunk * K] one plan's missing terms
  int* cjobs = smem + C.jobs;    // jobs | window end | (line, evicted term)
  int* lines = smem + C.rows;    // [cap][kLineRows * cpb]
  int* ckey = smem + C.key;      // [cap] the term a line holds, -1: none
  int* cstamp = smem + C.stamp;  // [cap] the last window that needs the line
  const int lw = kLineRows * cpb;

  // the block's slice of the non-term planes, once
  for (int row = 0; row < d_term_counts; ++row)
    for (int c = tid; c < cols; c += nt)
      cp_async4(s_state + row * cpb + c, st + row * N + lo + c);
  for (int row = 0; row < a_scores; ++row) {
    const int g = row < a_max_pods    ? s_alloc + row
                  : row == a_max_pods ? s_max_pods
                  : row == a_valid    ? s_node_valid
                  : row < a_masks     ? s_sc_codes + (row - a_sc_codes)
                                      : s_masks + (row - a_masks);
    for (int c = tid; c < cols; c += nt) cp_async4(s_stat + row * cpb + c, sta + g * N + lo + c);
  }
  for (int k = 0; k < u; ++k)
    for (int c = tid; c < cols; c += nt)
      cp_async4(s_stat + (a_scores + k) * cpb + c, sta_f + k * N + lo + c);
  cp_async_commit();
  for (int k = tid; k < t; k += nt) {
    totals[k] = st[d_totals * N + k];
    cslot[k] = -1;
    cmark[k] = -1;
  }
  for (int j = tid; j < C.cap; j += nt) {
    ckey[j] = -1;
    cstamp[j] = -2;  // free for the plans of windows 0 and 1
  }
  for (int k = tid; k < 2 * sc; k += nt) meta[k] = sc_meta[k];

  const int nchunks = (d.b + chunk - 1) / chunk;
  // pod p's row and weights: chunk p / chunk sits in buffer (p / chunk) %
  // kPodBufs
  auto pod_row = [&](int p) {
    return pod_i + ((p / chunk) % kPodBufs * chunk + p % chunk) * width;
  };
  auto pod_w = [&](int p) {
    return pod_f + ((p / chunk) % kPodBufs * chunk + p % chunk) * kSlots;
  };
  auto fetch = [&](int ch) {  // chunk ch's pods into its buffer
    const int p0 = ch * chunk, np = min(chunk, d.b - p0);
    int* di = pod_row(p0);
    const int* si = pod_ints + (size_t)p0 * width;
    for (int i = tid; i < np * width; i += nt) cp_async4(di + i, si + i);
    float* df = pod_w(p0);
    const float* sf = pod_floats + (size_t)p0 * kSlots;
    for (int i = tid; i < np * kSlots; i += nt) cp_async4(df + i, sf + i);
  };

  // Warp 0's plan of window x, the pods from `from` on in its chunk, while
  // window x - 1 runs, a lane a slot: a step takes 32 / w pods of w slots,
  // w the power of two that holds every pod's last active slot (the pack
  // puts a pod's references first, so w is 1 on a row of one reference a
  // pod). Each term the window lists for the first time (its mark; the
  // first of equal terms in a step) keeps its line if resident (stamped
  // x), else it misses. The window takes pods while the terms it lists
  // outside window x - 1 (hits on older lines and misses, each holding a
  // line) fit the lines window x - 1 leaves and, where T exceeds the
  // lines, while its own distinct terms leave the next window room: a
  // pod's K where the lines hold two pods' (then the first pod always
  // fits), else half the lines. Each miss then takes the clock's next line
  // that neither window x - 1 nor x needs (stamp below x - 1), evicting
  // the term it held: the jobs list those lines. Where the lines hold
  // fewer than two pods' K, window x's first pod may not fit beside window
  // x - 1: the window is then empty, and once window x - 1 is done it is
  // planned again `after` it, on all the lines (stamp below x).
  const int span = C.cap < 32 ? C.cap : 32;  // lines the clock looks at a step
  int hand = 0, wdist = 0;  // the clock; the last planned window's terms
  auto plan = [&](int x, int from, bool after) {
    const int end = min((from / chunk + 1) * chunk, d.b);
    const int budget = after ? C.cap : C.cap - wdist;
    const int limit = t <= C.cap ? INT_MAX : max(C.cap - kSlots, C.cap / 2);
    int w = 0;  // a lane a pod (the chunk holds at most 32): its last active slot
    if (from + lane < end) {
      const int* row = pod_row(from + lane);
      const float* wr = pod_w(from + lane);
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (row[c_flags + s] != 0 || wr[s] != 0.0f) w = s + 1;
    }
    w = __reduce_max_sync(0xffffffffu, w);
    const int lg = w <= 1 ? 0 : w <= 2 ? 1 : w <= 4 ? 2 : 3;  // log2 of the step's width
    const int per = 32 >> lg;                                 // pods a step
    int used = 0, dist = 0, nmiss = 0, hi = from;
    for (int p0 = from; p0 < end; p0 += per) {
      const int q = lane >> lg, s = lane & ((1 << lg) - 1), p = p0 + q;
      bool active = false;
      int k = 0;
      if (p < end) {
        const int* row = pod_row(p);
        active = row[c_flags + s] != 0 || pod_w(p)[s] != 0.0f;
        k = row[c_idx + s];
      }
      const bool fresh = active && cmark[k] != x;
      const unsigned peers = __match_any_sync(0xffffffffu, fresh ? k : -1 - lane);
      const bool first = fresh && __ffs(peers) - 1 == lane;
      const int j = first ? cslot[k] : -1;
      const bool held = first && (after || !(j >= 0 && cstamp[j] == x - 1));
      const unsigned fb = __ballot_sync(0xffffffffu, first);
      const unsigned hb = __ballot_sync(0xffffffffu, held);
      int taken = 0;
      bool stop = false;
      const unsigned low = (1u << (1 << lg)) - 1u;  // a pod's lanes
      for (; taken < per && p0 + taken < end; ++taken) {
        const int nf = __popc((fb >> (taken << lg)) & low);
        const int nh = __popc((hb >> (taken << lg)) & low);
        const bool later = p0 + taken > from;
        if ((used + nh > budget && (later || t > C.cap)) || (later && dist + nf > limit)) {
          stop = true;
          break;
        }
        used += nh;
        dist += nf;
      }
      const bool take = first && q < taken;
      if (take) {
        cmark[k] = x;
        if (j >= 0) cstamp[j] = x;
      }
      const unsigned mb = __ballot_sync(0xffffffffu, take && j < 0);
      if (take && j < 0) cmiss[nmiss + __popc(mb & ((1u << lane) - 1u))] = k;
      nmiss += __popc(mb);
      hi = p0 + taken;
      if (stop) break;
    }
    __syncwarp();
    for (int placed = 0; placed < nmiss;) {
      const int jj = hand + lane < C.cap ? hand + lane : hand + lane - C.cap;
      const bool free = lane < span && cstamp[jj] < (after ? x : x - 1);
      const unsigned fm = __ballot_sync(0xffffffffu, free);
      const int at = placed + __popc(fm & ((1u << lane) - 1u));
      const bool put = free && at < nmiss;
      if (put) {
        const int k = cmiss[at], old = ckey[jj];
        if (old >= 0) cslot[old] = -1;
        ckey[jj] = k;
        cslot[k] = jj;
        cstamp[jj] = x;
        cjobs[2 + 2 * at] = jj;
        cjobs[3 + 2 * at] = old;
      }
      const unsigned pm = __ballot_sync(0xffffffffu, put);
      placed += __popc(pm);
      // past the last line taken once all are placed, else the whole span
      const int step = placed >= nmiss ? 32 - __clz(pm) : span;
      hand = hand + step < C.cap ? hand + step : hand + step - C.cap;
    }
    if (lane == 0) {
      cjobs[0] = nmiss;
      cjobs[1] = hi;
    }
    wdist = dist;
  };
  // The plan's jobs, by every thread: the evicted term's owners and counts
  // written back at L2 (its codes are static), then the new term's three
  // rows copied in, 16 bytes a copy. A job's quad of columns is one
  // thread's, so the write-back reads a line before the copy refills it; a
  // later fill of the evicted term reads what the write-back stored (the
  // barriers between order them).
  auto run_jobs = [&]() {
    const int njobs = cjobs[0];
    for (int it = tid; it < njobs * quads; it += nt) {
      const int job = it / quads, c4 = (it - job * quads) * 4;
      const int j = cjobs[2 + 2 * job], old = cjobs[3 + 2 * job], k = ckey[j];
      int* ln = lines + j * lw;
      if (old >= 0) {
        __stcg(reinterpret_cast<int4*>(g_owners + (size_t)old * N + c4),
               *reinterpret_cast<const int4*>(ln + c4));
        __stcg(reinterpret_cast<int4*>(g_counts + (size_t)old * N + c4),
               *reinterpret_cast<const int4*>(ln + cpb + c4));
      }
      cp_async16(ln + c4, g_owners + (size_t)k * N + c4);
      cp_async16(ln + cpb + c4, g_counts + (size_t)k * N + c4);
      cp_async16(ln + 2 * cpb + c4, g_codes + (size_t)k * N + c4);
    }
  };

  // chunks 0 and 1's pods, then window 0's plan and lines
  if (nchunks > 0) fetch(0);
  cp_async_commit();
  if (nchunks > 1) fetch(1);
  cp_async_commit();
  cp_async_wait<1>();  // the slices and chunk 0's pods
  __syncthreads();
  int wlo = 0, whi = 0;  // the running window's pods
  if (d.b > 0) {
    if (warp == 0) plan(0, 0, false);
    __syncthreads();
    whi = cjobs[1];
    run_jobs();
  }
  cp_async_commit();

  // every block of the cluster is running before any slot is written
  cluster_arrive();
  cluster_wait();

  int par_min = 0, par_best = 0;
  for (int x = 0; wlo < d.b; ++x) {
    // window x's lines and the next chunk's pods have landed
    cp_async_wait<0>();
    __syncthreads();
    const int ch = wlo / chunk, c0 = ch * chunk, np = min(chunk, d.b - c0);
    const bool opens = wlo == c0;  // the chunk's first window
    // warp 0 plans window x + 1 while, on a chunk's first window, the last
    // threads build each of its pods' uniform facts (on a one-warp block,
    // after the plan). An inactive slot (index 0, flags 0, weight 0.0)
    // enters no list: its flags and weight say so, not its index, which is
    // also a real term's.
    if (whi < d.b && warp == 0) plan(x + 1, whi, false);
    if (opens && nt - 1 - tid < np) {
      const int i = nt - 1 - tid;
      const int* row = pod_row(c0 + i);
      const float* wrow = pod_w(c0 + i);
      int* f = facts + i * fstride;
      int* hard = f + kHead;
      int* soft = hard + sc;
      int* scc = soft + sc;
      int* tf = scc + sc;
      int* aff = tf + kSlots;
      int* pref = aff + kSlots;
      int nh = 0, ns = 0, nscc = 0, ntf = 0, naff = 0, npref = 0, self_all = 1;
      for (int k = 0; k < sc; ++k) {
        if (row[c_pod_sc + k] > 0) {
          if (meta[sc + k] > 0)
            hard[nh++] = k;
          else
            soft[ns++] = k;
        }
        if (row[c_sc_match + k] != 0) scc[nscc++] = k;
      }
      for (int s = 0; s < kSlots; ++s) {  // slots are in term order
        const int fl = row[c_flags + s];
        if (fl & (kMatched | kOwnAnti)) tf[ntf++] = s;
        if (fl & kOwnAff) {
          aff[naff++] = s;
          self_all = self_all && (fl & kMatched);
        }
        if (wrow[s] != 0.0f) pref[npref++] = s;
      }
      f[kNHard] = nh;
      f[kNSoft] = ns;
      f[kNScc] = nscc;
      f[kNTf] = ntf;
      f[kNAff] = naff;
      f[kNPref] = npref;
      f[kSelfAll] = self_all;
    }
    __syncthreads();
    // window x + 1's lines come in, and on a chunk's first window the pods
    // of the chunk after the next, while window x runs
    int next = whi < d.b ? cjobs[1] : whi;
    if (whi < d.b) run_jobs();
    if (opens && ch + 2 < nchunks) fetch(ch + 2);
    cp_async_commit();

    for (int p = wlo; p < whi; ++p) {
      const int i = p - c0;
      const int* row = pod_row(p);
      const float* wrow = pod_w(p);
      if (row[c_valid] <= 0) {  // padding or inexpressible: no node, no commit
        if (rank == 0 && tid == 0) assign[p] = -1;
        continue;
      }
      const int* f = facts + i * fstride;
      const int nh = f[kNHard], ns = f[kNSoft], nscc = f[kNScc], ntf = f[kNTf];
      const int naff = f[kNAff], npref = f[kNPref];
      const int* hard = f + kHead;
      const int* soft = hard + sc;
      const int* scc = soft + sc;
      const int* tf = scc + sc;
      const int* aff = tf + kSlots;
      const int* pref = aff + kSlots;
      const int* idx = row + c_idx;
      const int* flags = row + c_flags;
      const int profile = row[c_profile];
      const int* mask_row = s_stat + (a_masks + profile) * cpb;
      const float* static_row = reinterpret_cast<const float*>(s_stat + (a_scores + profile) * cpb);

      // hard spread: this block's domain minima of every active constraint,
      // published to every block; the barrier's wait comes after the filter
      if (nh > 0) {
        for (int h = 0; h < nh; ++h) {
          const int k = hard[h];
          const int* dom = sta + (s_sc_domain + profile * sc + k) * N + lo;
          const int* counts = s_state + (d_sc_counts + k) * cpb;
          int m = kBig;
          for (int c = tid; c < cols; c += nt)
            if (__ldg(dom + c) > 0) m = min(m, counts[c]);
          m = warp_min(m);
          if (lane == 0) wmin[h * nwarps + warp] = m;
        }
        __syncthreads();
        for (int h = tid; h < nh; h += nt) {
          int m = kBig;
          for (int q = 0; q < nwarps; ++q) m = min(m, wmin[h * nwarps + q]);
          int* slot = slot_min + (par_min * nc + rank) * sc + h;
          for (int q = 0; q < nc; ++q) *cluster.map_shared_rank(slot, q) = m;
        }
        cluster_arrive();
      }
      // required affinity: the first pod of a group passes anywhere when no
      // pod matches any of its terms yet and it matches all of them itself
      bool need_aff = false;
      if (naff > 0) {
        if (nh == 0) __syncthreads();  // thread 0's totals of the last commit
        bool no_any = true;
        for (int x = 0; x < naff; ++x) no_any = no_any && totals[idx[aff[x]]] == 0;
        need_aff = !(no_any && f[kSelfAll]);
      }

      // filter (all but the skew check) and score; -inf marks infeasible.
      // The term rows are the cache's lines: owners at 0, counts at cpb,
      // codes at 2 * cpb.
      for (int c = tid; c < cols; c += nt) {
        bool ok = (s_stat[a_valid * cpb + c] > 0) &
                  (s_state[d_pod_count * cpb + c] < s_stat[a_max_pods * cpb + c]) &
                  (mask_row[c] > 0);
        for (int k = 0; k < r; ++k)
          ok = ok & (s_state[(d_req + k) * cpb + c] + row[k] <= s_stat[k * cpb + c]);
        for (int x = 0; x < ntf; ++x) {
          const int s = tf[x];
          const int* ln = lines + cslot[idx[s]] * lw;
          const int owners = (flags[s] & kMatched) ? ln[c] : 0;
          const int counts = (flags[s] & kOwnAnti) ? ln[cpb + c] : 0;
          ok = ok & (owners <= 0) & (counts <= 0);
        }
        for (int x = 0; need_aff && x < naff; ++x) {
          const int* ln = lines + cslot[idx[aff[x]]] * lw;
          ok = ok & (ln[cpb + c] > 0) & (ln[2 * cpb + c] < v);
        }
        for (int h = 0; h < nh; ++h) ok = ok & (s_stat[(a_sc_codes + hard[h]) * cpb + c] < v);
        const float alloc_cpu = (float)max(s_stat[c], 1);
        const float alloc_mem = (float)max(s_stat[cpb + c], 1);
        const float cpu = (float)(s_state[d_nz * cpb + c] + row[c_nz]) / alloc_cpu;
        const float mem = (float)(s_state[(d_nz + 1) * cpb + c] + row[c_nz + 1]) / alloc_mem;
        const bool over = cpu >= 1.0f || mem >= 1.0f;
        const float balanced = over ? 0.0f : (1.0f - fabsf(cpu - mem)) * 100.0f;
        const float least =
            (fminf(fmaxf(1.0f - cpu, 0.0f), 1.0f) + fminf(fmaxf(1.0f - mem, 0.0f), 1.0f)) * 50.0f;
        float spread = 0.0f;
        if (ns > 0) {
          float soft_sum = 0.0f;
          for (int x = 0; x < ns; ++x)
            soft_sum += (float)s_state[(d_sc_counts + soft[x]) * cpb + c];
          spread = 100.0f / (1.0f + soft_sum);
        }
        // the slots with a weight, in term order from 0.0 as solve_plain
        // sums them; the reference's sum over all K slots also adds +0.0
        // for the others, which changes no value, so skipping them is exact
        float pref_sum = 0.0f;
        for (int x = 0; x < npref; ++x) {
          const int s = pref[x];
          pref_sum += wrow[s] * (float)lines[cslot[idx[s]] * lw + cpb + c];
        }
        float s = w.balanced * balanced;
        s = s + w.least * least;
        s = s + w.spread * spread;
        s = s + w.affinity * pref_sum;
        s = s + w.stat * static_row[c];
        s_score[c] = ok ? s : -INFINITY;
      }

      // the skew check against the cluster's minima, and this block's best
      if (nh > 0) cluster_wait();
      const int* mins = slot_min + par_min * nc * sc;
      float best_s = -INFINITY;
      int best_j = INT_MAX;
      for (int c = tid; c < cols; c += nt) {
        const float s = s_score[c];
        if (s == -INFINITY) continue;
        bool ok = true;
        for (int h = 0; ok && h < nh; ++h) {
          const int k = hard[h];
          int m = kBig;
          for (int q = 0; q < nc; ++q) m = min(m, mins[q * sc + h]);
          m = m < kBig ? m : 0;  // 0 when the profile has no eligible domain
          ok = s_state[(d_sc_counts + k) * cpb + c] + row[c_sc_match + k] - m <= meta[k];
        }
        if (ok) better(best_s, best_j, s, lo + c);
      }
      warp_best(best_s, best_j);
      if (lane == 0) {
        wbest_s[warp] = best_s;
        wbest_j[warp] = best_j;
      }
      __syncthreads();
      if (warp == 0) {
        float s = -INFINITY;
        int j = INT_MAX;
        if (lane < nwarps) {
          s = wbest_s[lane];
          j = wbest_j[lane];
        }
        warp_best(s, j);
        s = __shfl_sync(0xffffffffu, s, 0);
        j = __shfl_sync(0xffffffffu, j, 0);
        if (lane < nc) {
          *cluster.map_shared_rank(slot_s + par_best * nc + rank, lane) = s;
          *cluster.map_shared_rank(slot_j + par_best * nc + rank, lane) = j;
        }
      }
      cluster_arrive();
      cluster_wait();
      best_s = -INFINITY;
      best_j = INT_MAX;
      for (int q = 0; q < nc; ++q) better(best_s, best_j, slot_s[par_best * nc + q], slot_j[par_best * nc + q]);
      par_best ^= 1;
      if (nh > 0) par_min ^= 1;
      if (best_j == INT_MAX || !(best_s > kFoundThreshold)) {
        if (rank == 0 && tid == 0) assign[p] = -1;
        continue;  // uniform: every block reduced the same candidates
      }

      // commit to node jc, each block on its own columns
      const int jc = best_j, cj = jc - lo;
      if (cj >= 0 && cj < cols && cj % nt == tid) {
        for (int k = 0; k < r; ++k) s_state[(d_req + k) * cpb + cj] += row[k];
        s_state[d_nz * cpb + cj] += row[c_nz];
        s_state[(d_nz + 1) * cpb + cj] += row[c_nz + 1];
        s_state[d_pod_count * cpb + cj] += 1;
      }
      for (int x = 0; x < nscc; ++x) {
        const int k = scc[x];
        const int inc = row[c_sc_match + k];
        const int code_j = __ldg(sta + (s_sc_codes + k) * N + jc);
        const int* codes = s_stat + (a_sc_codes + k) * cpb;
        int* counts = s_state + (d_sc_counts + k) * cpb;
        for (int c = tid; c < cols; c += nt)
          if (codes[c] == code_j) counts[c] += inc;
      }
      // the term step: slots with the matched or own-anti bit, on the lines
      for (int x = 0; x < ntf; ++x) {
        const int s = tf[x], k = idx[s];
        const int matched = flags[s] & kMatched, anti = (flags[s] & kOwnAnti) ? 1 : 0;
        const int code_j = __ldg(sta + (s_term_codes + k) * N + jc);
        int* ln = lines + cslot[k] * lw;
        for (int c = tid; c < cols; c += nt) {
          if (ln[2 * cpb + c] != code_j) continue;
          if (matched) ln[cpb + c] += 1;
          if (anti) ln[c] += 1;
        }
        if (tid == 0 && code_j < v) totals[k] += matched;
      }
      if (rank == 0 && tid == 0) assign[p] = jc;
    }
    if (next == whi && whi < d.b) {
      // window x + 1 was empty: its first pod's terms did not fit beside
      // window x's lines, which are free now
      __syncthreads();
      if (warp == 0) plan(x + 1, whi, true);
      __syncthreads();
      next = cjobs[1];
      run_jobs();
      cp_async_commit();
    }
    wlo = whi;
    whi = next;
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int row = 0; row < d_term_counts; ++row)
    for (int c = tid; c < cols; c += nt) st[row * N + lo + c] = s_state[row * cpb + c];
  for (int c = tid; c < cols; c += nt) {
    const int j = lo + c;
    st[d_totals * N + j] = j < t ? totals[j] : 0;
  }
  // the resident terms' owners and counts back at L2
  for (int it = tid; it < C.cap * quads; it += nt) {
    const int j = it / quads, c4 = (it - j * quads) * 4, k = ckey[j];
    if (k < 0) continue;
    const int* ln = lines + j * lw;
    __stcg(reinterpret_cast<int4*>(g_owners + (size_t)k * N + c4),
           *reinterpret_cast<const int4*>(ln + c4));
    __stcg(reinterpret_cast<int4*>(g_counts + (size_t)k * N + c4),
           *reinterpret_cast<const int4*>(ln + cpb + c4));
  }
  // no block leaves while another may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// The wide kernel (see the note at the top) and the sharded kernel share this
// body. Pods come as the dense stream, as for the cluster kernel. kSv as in
// the cluster kernel; kSlices: the block's slices of the non-term state and
// static rows are in shared memory (else read at L2 by the owning thread, as
// the term rows always are). kMode kOneCluster: the wide kernel, one cluster
// over the node axis. kGroups: the sharded kernel with every shard in one
// cluster, shard s on blocks [s * g, (s + 1) * g), each pod's best and
// domain minima exchanged in distributed shared memory. kMesh: the sharded
// kernel with a cluster a shard, cluster s of the launch over shard s's
// columns, each pod's best exchanged through global memory; kMeshHard: the
// same with the round of hard-spread domain minima. kOneCluster compiles
// none of the mesh's code, so the wide kernel runs as it did before the
// sharded kernel existed; kGroups none of the global exchange.
enum { kOneCluster = 0, kGroups = 1, kMesh = 2, kMeshHard = 3 };

template <bool kSv, bool kSlices, int kMode>
__device__ __forceinline__ void wide_solve(const int* __restrict__ sc_meta,
                                           const int* __restrict__ pod_ints,
                                           const float* __restrict__ pod_floats,
                                           const int* __restrict__ sta,
                                           const float* __restrict__ sta_f, int* __restrict__ st,
                                           int* __restrict__ assign, const Dims& d,
                                           const Weights& w, const Plan& pl, const Shard& sh) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nc = pl.cluster;
  const Layout L = kMode == kOneCluster ? wide_layout(d, pl, kSlices)
                                        : sharded_layout(d, pl, kSlices);
  constexpr bool kGlobal = kMode >= kMesh;  // the exchange through global memory

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int r = d.r, sc = d.sc, t = d.t, u = d.u, v = d.v, n = d.n;
  const size_t N = (size_t)n;
  const int cpb = pl.cpb, chunk = pl.chunk;
  const bool staged = chunk > 0;
  const int per = staged ? chunk : 1;  // pods a round
  // this block's shard of the node axis (all of it for the wide kernel) and
  // its place among the shard's `group` blocks: the cluster's g = nc / S on
  // the one-cluster route, the whole cluster on the global one
  const int shards = kMode == kOneCluster ? 1 : sh.shards;
  const int group = kMode == kGroups ? nc / shards : nc;
  const int shard = kMode == kOneCluster ? 0
                    : kMode == kGroups   ? rank / group
                                         : (int)blockIdx.x / nc;
  const int q_in = kMode == kGroups ? rank - shard * group : rank;
  const int nl = kMode == kOneCluster ? n : sh.nl;
  const int lo = shard * nl + q_in * cpb;
  const int cols = max(0, min(cpb, nl - q_in * cpb));
  const bool lead = rank == 0 && shard == 0;  // writes the assignments
  const Exchange X = sharded_workspace(shards, sc, t);
  int* err = kGlobal ? sh.ws + X.err : nullptr;

  // global static plane rows
  const int s_alloc = 0, s_max_pods = r, s_masks = r + 1, s_sc_codes = r + 1 + u;
  const int s_sc_domain = s_sc_codes + sc, s_term_codes = s_sc_domain + u * sc;
  const int s_node_valid = s_term_codes + t;
  // state plane rows; those before the term rows are the slices
  const int d_req = 0, d_nz = r, d_pod_count = r + 2, d_sc_counts = r + 3;
  const int d_term_counts = d_sc_counts + sc, d_term_owners = d_term_counts + t;
  const int d_sv = d_term_owners + t, d_totals = d_sv + (kSv ? d.sv : 0);
  // shared static rows: alloc[R] | max_pods | node_valid | sc_codes[SC] |
  // masks[U] | static scores[U] (f32)
  const int a_max_pods = r, a_valid = r + 1, a_sc_codes = r + 2, a_masks = r + 2 + sc;
  const int a_scores = a_masks + u;
  // pod stream columns
  const int c_nz = r, c_profile = r + 2, c_valid = r + 3, c_pod_sc = r + 4;
  const int c_sc_match = c_pod_sc + sc, c_match_by = c_sc_match + sc;
  const int c_own_aff = c_match_by + t, c_own_anti = c_own_aff + t;
  const int c_sv = c_own_anti + t;
  const int width = c_sv + (kSv ? 2 : 0);  // pod_width(d): kSv is d.sv > 0
  const int fstride = wide_fact_stride(sc, t);

  // this block's columns of the global rows: row k at k * N
  int* g_state = st + lo;
  const int* g_stat = sta + lo;
  const float* g_score = sta_f + lo;
  int* g_counts = st + d_term_counts * N + lo;
  int* g_owners = st + d_term_owners * N + lo;
  const int* g_codes = sta + s_term_codes * N + lo;

  int* s_state = smem + L.state;
  int* s_stat = smem + L.stat;
  float* s_score = reinterpret_cast<float*>(smem + L.score);
  int* totals = smem + L.totals;
  int* meta = smem + L.meta;
  int* pod_i = smem + L.pod_i;
  float* pod_f = reinterpret_cast<float*>(smem + L.pod_f);
  int* facts = smem + L.facts;
  int* wmin = smem + L.wmin;
  float* wbest_s = reinterpret_cast<float*>(smem + L.wbest);
  int* wbest_j = smem + L.wbest + nwarps;
  int* slot_min = smem + L.slot_min;  // [2][cluster][SC]
  float* slot_s = reinterpret_cast<float*>(smem + L.slot_best);  // [2][cluster]
  int* slot_j = smem + L.slot_best + 2 * nc;                    // [2][cluster]
  float* xwin_s = reinterpret_cast<float*>(smem + L.xwin);      // [2], sharded
  int* xwin_j = smem + L.xwin + 2;                              // [2], sharded

  // A non-term state row (global row number) at column c of the slice, and
  // an add to it by the thread owning c: shared memory, or L2 (the kernel
  // writes these rows, so never through the read-only path).
  auto state_at = [&](int row, int c) -> int {
    if constexpr (kSlices)
      return s_state[row * cpb + c];
    else
      return __ldcg(g_state + row * N + c);
  };
  auto state_add = [&](int row, int c, int x) {
    if constexpr (kSlices) {
      s_state[row * cpb + c] += x;
    } else {
      int* q = g_state + row * N + c;
      __stcg(q, __ldcg(q) + x);
    }
  };
  // A static int row: its index in the shared layout (a) and in the global
  // planes (g).
  auto stat_at = [&](int a, int g, int c) -> int {
    if constexpr (kSlices)
      return s_stat[a * cpb + c];
    else
      return __ldg(g_stat + g * N + c);
  };

  // the block's slice of the non-term planes, once
  if constexpr (kSlices) {
    for (int row = 0; row < d_term_counts; ++row)
      for (int c = tid; c < cols; c += nt)
        cp_async4(s_state + row * cpb + c, st + row * N + lo + c);
    for (int row = 0; row < a_scores; ++row) {
      const int g = row < a_max_pods    ? s_alloc + row
                    : row == a_max_pods ? s_max_pods
                    : row == a_valid    ? s_node_valid
                    : row < a_masks     ? s_sc_codes + (row - a_sc_codes)
                                        : s_masks + (row - a_masks);
      for (int c = tid; c < cols; c += nt) cp_async4(s_stat + row * cpb + c, sta + g * N + lo + c);
    }
    for (int k = 0; k < u; ++k)
      for (int c = tid; c < cols; c += nt)
        cp_async4(s_stat + (a_scores + k) * cpb + c, sta_f + k * N + lo + c);
  }
  cp_async_commit();
  // the totals: the planes' row, or the shard's own copy
  for (int k = tid; k < t; k += nt)
    totals[k] = kMode == kOneCluster ? st[d_totals * N + k] : sh.totals[shard * t + k];
  for (int k = tid; k < 2 * sc; k += nt) meta[k] = sc_meta[k];

  const int rounds = (d.b + per - 1) / per;
  auto fetch = [&](int ch) {
    const int p0 = ch * chunk, np = min(chunk, d.b - p0), buf = ch & 1;
    int* di = pod_i + buf * chunk * width;
    const int* si = pod_ints + (size_t)p0 * width;
    for (int i = tid; i < np * width; i += nt) cp_async4(di + i, si + i);
    float* df = pod_f + buf * chunk * t;
    const float* sf = pod_floats + (size_t)p0 * t;
    for (int i = tid; i < np * t; i += nt) cp_async4(df + i, sf + i);
  };
  if (staged && rounds > 0) fetch(0);
  cp_async_commit();

  // every block of the cluster is running before any slot is written
  cluster_arrive();
  cluster_wait();

  int par_min = 0, par_best = 0;
  for (int ch = 0; ch < rounds; ++ch) {
    if (staged && ch + 1 < rounds) fetch(ch + 1);
    cp_async_commit();
    cp_async_wait<1>();  // the slices and this chunk have landed
    __syncthreads();
    const int p0 = ch * per, np = min(per, d.b - p0), buf = ch & 1;
    // the round's rows: the staged chunk, or (chunk 0) the pod's row where
    // it lies in global memory
    const int* rows = staged ? pod_i + buf * chunk * width : pod_ints + (size_t)p0 * width;
    const float* frows = staged ? pod_f + buf * chunk * t : pod_floats + (size_t)p0 * t;

    // each pod's uniform facts, once: a warp a pod, the term references
    // compacted by ballots, so the list keeps the increasing term order
    for (int i = warp; i < np; i += nwarps) {
      const int* row = rows + i * width;
      const float* wrow = frows + i * t;
      int* f = facts + i * fstride;
      int* hard = f + kHead;
      int* soft = hard + sc;
      int* scc = soft + sc;
      int* refs = scc + sc;
      if (lane == 0) {
        int nh = 0, ns = 0, nscc = 0;
        for (int k = 0; k < sc; ++k) {
          if (row[c_pod_sc + k] > 0) {
            if (meta[sc + k] > 0)
              hard[nh++] = k;
            else
              soft[ns++] = k;
          }
          if (row[c_sc_match + k] != 0) scc[nscc++] = k;
        }
        f[kNHard] = nh;
        f[kNSoft] = ns;
        f[kNScc] = nscc;
      }
      int nref = 0, naff = 0;
      bool self_all = true;
      for (int k0 = 0; k0 < t; k0 += 32) {
        const int k = k0 + lane;
        int e = 0;
        if (k < t) {
          const int matched = row[c_match_by + k], aff = row[c_own_aff + k];
          const int anti = row[c_own_anti + k];
          e = (matched > 0 ? kRefOwners : 0) | (anti > 0 ? kRefCounts : 0) |
              (aff > 0 ? kRefAff : 0) | (wrow[k] != 0.0f ? kRefPref : 0) |
              (matched != 0 || anti != 0 ? kRefCommit : 0);
          if (aff > 0 && !(matched > 0)) self_all = false;
        }
        const unsigned any = __ballot_sync(0xffffffffu, e != 0);
        if (e != 0) refs[nref + __popc(any & ((1u << lane) - 1u))] = (k << kRefShift) | e;
        nref += __popc(any);
        naff += __popc(__ballot_sync(0xffffffffu, (e & kRefAff) != 0));
      }
      self_all = __all_sync(0xffffffffu, self_all);
      if (lane == 0) {
        f[kNTf] = nref;
        f[kNAff] = naff;
        f[kSelfAll] = self_all;
      }
    }
    __syncthreads();

    for (int i = 0; i < np; ++i) {
      const int p = p0 + i;
      const int* row = rows + i * width;
      const float* wrow = frows + i * t;
      if (row[c_valid] <= 0) {  // padding or inexpressible: no node, no commit
        if (lead && tid == 0) assign[p] = -1;
        continue;
      }
      const int* f = facts + i * fstride;
      const int nh = f[kNHard], ns = f[kNSoft], nscc = f[kNScc], nref = f[kNTf];
      const int naff = f[kNAff];
      const int* hard = f + kHead;
      const int* soft = hard + sc;
      const int* scc = soft + sc;
      const int* refs = scc + sc;
      const int profile = row[c_profile];
      // the pod's shared volume: its sv row (this block's columns, at L2)
      // and attach column
      const int slot = kSv ? row[c_sv] : 0, vcol = kSv ? row[c_sv + 1] : 0;
      int* att = kSv && slot < d.sv ? st + (size_t)(d_sv + slot) * N + lo : nullptr;

      // hard spread: this block's domain minima of every active constraint,
      // published to every block; the barrier's wait comes after the filter
      if (nh > 0) {
        for (int h = 0; h < nh; ++h) {
          const int k = hard[h];
          const int* dom = sta + (s_sc_domain + profile * sc + k) * N + lo;
          int m = kBig;
          for (int c = tid; c < cols; c += nt)
            if (__ldg(dom + c) > 0) m = min(m, state_at(d_sc_counts + k, c));
          m = warp_min(m);
          if (lane == 0) wmin[h * nwarps + warp] = m;
        }
        __syncthreads();
        for (int h = tid; h < nh; h += nt) {
          int m = kBig;
          for (int q = 0; q < nwarps; ++q) m = min(m, wmin[h * nwarps + q]);
          int* slot = slot_min + (par_min * nc + rank) * sc + h;
          for (int q = 0; q < nc; ++q) *cluster.map_shared_rank(slot, q) = m;
        }
        cluster_arrive();
      }
      // required affinity: the first pod of a group passes anywhere when no
      // pod matches any of its terms yet and it matches all of them itself
      bool need_aff = false;
      if (naff > 0) {
        if (nh == 0) __syncthreads();  // thread 0's totals of the last commit
        bool no_any = true;
        for (int x = 0; x < nref; ++x) {
          const int e = refs[x];
          if (e & kRefAff) no_any = no_any && totals[e >> kRefShift] == 0;
        }
        need_aff = !(no_any && f[kSelfAll]);
      }

      // filter (all but the skew check) and score; -inf marks infeasible.
      // The term rows are read at L2, only at this block's columns, each
      // term's counts once for both filters and the preferred sum.
      for (int c = tid; c < cols; c += nt) {
        bool ok = (stat_at(a_valid, s_node_valid, c) > 0) &
                  (state_at(d_pod_count, c) < stat_at(a_max_pods, s_max_pods, c)) &
                  (stat_at(a_masks + profile, s_masks + profile, c) > 0);
        for (int k = 0; k < r; ++k)
          ok = ok & (state_at(d_req + k, c) + row[k] <= stat_at(k, s_alloc + k, c));
        if (att != nullptr)
          ok = ok & (state_at(d_req + vcol, c) + row[vcol] + (1 - __ldcg(att + c)) <=
                     stat_at(vcol, s_alloc + vcol, c));
        float pref_sum = 0.0f;
        for (int x = 0; x < nref; ++x) {
          const int e = refs[x];
          const size_t at = (size_t)(e >> kRefShift) * N + c;
          if (e & kRefOwners) ok = ok & (__ldcg(g_owners + at) <= 0);
          if (e & (kRefCounts | kRefAff | kRefPref)) {
            const int counts = __ldcg(g_counts + at);
            if (e & kRefCounts) ok = ok & (counts <= 0);
            if (need_aff && (e & kRefAff)) ok = ok & (counts > 0) & (__ldg(g_codes + at) < v);
            if (e & kRefPref) pref_sum += wrow[e >> kRefShift] * (float)counts;
          }
        }
        for (int h = 0; h < nh; ++h)
          ok = ok & (stat_at(a_sc_codes + hard[h], s_sc_codes + hard[h], c) < v);
        const float alloc_cpu = (float)max(stat_at(0, s_alloc, c), 1);
        const float alloc_mem = (float)max(stat_at(1, s_alloc + 1, c), 1);
        const float cpu = (float)(state_at(d_nz, c) + row[c_nz]) / alloc_cpu;
        const float mem = (float)(state_at(d_nz + 1, c) + row[c_nz + 1]) / alloc_mem;
        const bool over = cpu >= 1.0f || mem >= 1.0f;
        const float balanced = over ? 0.0f : (1.0f - fabsf(cpu - mem)) * 100.0f;
        const float least =
            (fminf(fmaxf(1.0f - cpu, 0.0f), 1.0f) + fminf(fmaxf(1.0f - mem, 0.0f), 1.0f)) * 50.0f;
        float spread = 0.0f;
        if (ns > 0) {
          float soft_sum = 0.0f;
          for (int x = 0; x < ns; ++x) soft_sum += (float)state_at(d_sc_counts + soft[x], c);
          spread = 100.0f / (1.0f + soft_sum);
        }
        float static_score;
        if constexpr (kSlices)
          static_score = reinterpret_cast<const float*>(s_stat + (a_scores + profile) * cpb)[c];
        else
          static_score = __ldg(g_score + profile * N + c);
        float s = w.balanced * balanced;
        s = s + w.least * least;
        s = s + w.spread * spread;
        s = s + w.affinity * pref_sum;
        s = s + w.stat * static_score;
        s_score[c] = ok ? s : -INFINITY;
      }

      // the skew check against the cluster's minima, and this block's best
      if (nh > 0) cluster_wait();
      const int* mins = slot_min + par_min * nc * sc;
      if constexpr (kMode == kMeshHard) {
        // the shards' minima: the cluster's goes to global memory, released
        // by a flag; every block reads all shards' and keeps the least of
        // each constraint in wmin (free since the cluster's wait)
        if (nh > 0) {
          const int par = p & 1;
          if (rank == 0) {
            for (int h = tid; h < nh; h += nt) {
              int m = kBig;
              for (int q = 0; q < nc; ++q) m = min(m, mins[q * sc + h]);
              __stcg(sh.ws + X.xmin + (par * shards + shard) * sc + h, m);
              __threadfence();
            }
            __syncthreads();
            if (tid == 0) st_release(sh.ws + X.flag_min + (par * shards + shard) * kFlagStride, p + 1);
          }
          if (warp == 0) {
            const bool got =
                lane < shards &&
                poll_flag(sh.ws + X.flag_min + (par * shards + lane) * kFlagStride, p + 1, err);
            for (int h = 0; h < nh; ++h) {
              int m = got ? __ldcg(sh.ws + X.xmin + (par * shards + lane) * sc + h) : kBig;
              m = warp_min(m);
              if (lane == 0) wmin[h] = m;
            }
          }
          __syncthreads();
        }
      } else if constexpr (kMode == kMesh) {
        // an instance without the round took a pod with hard spread
        if (nh > 0 && lead && tid == 0) atomicCAS(err, 0, kErrHard);
      }
      float best_s = -INFINITY;
      int best_j = INT_MAX;
      for (int c = tid; c < cols; c += nt) {
        const float s = s_score[c];
        if (s == -INFINITY) continue;
        bool ok = true;
        for (int h = 0; ok && h < nh; ++h) {
          const int k = hard[h];
          int m = kBig;
          if constexpr (kMode == kOneCluster) {
            for (int q = 0; q < nc; ++q) m = min(m, mins[q * sc + h]);
            m = m < kBig ? m : 0;  // 0 when the profile has no eligible domain
          } else if constexpr (kMode == kGroups) {
            // the pmin: every shard's blocks published their minima into
            // this block's slots, so the mesh's minimum is the least of
            // them; the reference's rule takes it where the profile has an
            // eligible domain value at all, else 0
            if (__ldg(sh.has_dom + profile * sc + k))
              for (int q = 0; q < nc; ++q) m = min(m, mins[q * sc + h]);
            else
              m = 0;
          } else {
            // the reference's rule: the mesh's minimum where the profile has
            // an eligible domain value at all, else 0
            m = __ldg(sh.has_dom + profile * sc + k) ? wmin[h] : 0;
          }
          ok = state_at(d_sc_counts + k, c) + row[c_sc_match + k] - m <= meta[k];
        }
        if (ok) better(best_s, best_j, s, lo + c);
      }
      warp_best(best_s, best_j);
      if (lane == 0) {
        wbest_s[warp] = best_s;
        wbest_j[warp] = best_j;
      }
      __syncthreads();
      if (warp == 0) {
        float s = -INFINITY;
        int j = INT_MAX;
        if (lane < nwarps) {
          s = wbest_s[lane];
          j = wbest_j[lane];
        }
        warp_best(s, j);
        s = __shfl_sync(0xffffffffu, s, 0);
        j = __shfl_sync(0xffffffffu, j, 0);
        if (lane < nc) {
          *cluster.map_shared_rank(slot_s + par_best * nc + rank, lane) = s;
          *cluster.map_shared_rank(slot_j + par_best * nc + rank, lane) = j;
        }
      }
      cluster_arrive();
      cluster_wait();
      // the best of the cluster's slots (on the one-cluster route every
      // shard's blocks): the higher score, then the lower index, a total
      // order, so the best of all blocks is the best of the shards' bests,
      // as the reference resolves its gathered rows
      best_s = -INFINITY;
      best_j = INT_MAX;
      for (int q = 0; q < nc; ++q) better(best_s, best_j, slot_s[par_best * nc + q], slot_j[par_best * nc + q]);
      par_best ^= 1;
      if (nh > 0) par_min ^= 1;
      // the winner's codes: the static planes (the whole mesh is on this
      // card), or on the global route the winning shard's payload
      const int* wcodes = nullptr;
      if constexpr (kGlobal) {
        // the exchange: the cluster's first block publishes the shard's best
        // (score, index, that column's codes) in its parity's payload and
        // releases its flag with the pod's sequence number; every block reads
        // all shards' flags and payloads and takes the best, the lowest index
        // on equal scores. A shard writes parity p & 1 again only at pod
        // p + 2, after every shard's flag of pod p + 1, which each raises only
        // once all its blocks are past pod p: two parities suffice.
        const int par = p & 1;
        int* xrow = sh.ws + X.xch + (par * shards + shard) * X.xw;
        if (rank == 0 && warp == 0) {
          const bool any = best_j != INT_MAX;
          for (int k = lane; k < sc + t; k += 32) {
            const int g = k < sc ? s_sc_codes + k : s_term_codes + (k - sc);
            __stcg(xrow + 2 + k, any ? __ldg(sta + g * N + best_j) : 0);
          }
          if (lane == 0) {
            __stcg(reinterpret_cast<float*>(xrow), best_s);
            __stcg(xrow + 1, best_j);
          }
          __threadfence();
          __syncwarp();
          if (lane == 0) st_release(sh.ws + X.flag_best + (par * shards + shard) * kFlagStride, p + 1);
        }
        if (warp == 0) {
          float s = -INFINITY;
          int j = INT_MAX;
          if (lane < shards &&
              poll_flag(sh.ws + X.flag_best + (par * shards + lane) * kFlagStride, p + 1, err)) {
            const int* row_q = sh.ws + X.xch + (par * shards + lane) * X.xw;
            s = __ldcg(reinterpret_cast<const float*>(row_q));
            j = __ldcg(row_q + 1);
          }
          warp_best(s, j);
          if (lane == 0) {
            xwin_s[par] = s;
            xwin_j[par] = j;
          }
        }
        __syncthreads();
        best_s = xwin_s[par];
        best_j = xwin_j[par];
        if (best_j != INT_MAX) wcodes = sh.ws + X.xch + (par * shards + best_j / nl) * X.xw + 2;
      }
      if (best_j == INT_MAX || !(best_s > kFoundThreshold)) {
        if (lead && tid == 0) assign[p] = -1;
        continue;  // uniform: every block reduced the same candidates
      }

      // commit to node jc, each block on its own columns
      const int jc = best_j, cj = jc - lo;
      if (cj >= 0 && cj < cols && cj % nt == tid) {
        for (int k = 0; k < r; ++k) state_add(d_req + k, cj, row[k]);
        state_add(d_nz, cj, row[c_nz]);
        state_add(d_nz + 1, cj, row[c_nz + 1]);
        state_add(d_pod_count, cj, 1);
        if (att != nullptr) {  // one more attachment where it was not attached
          state_add(d_req + vcol, cj, 1 - __ldcg(att + cj));
          __stcg(att + cj, 1);
        }
      }
      for (int x = 0; x < nscc; ++x) {
        const int k = scc[x];
        const int inc = row[c_sc_match + k];
        const int code_j = kGlobal ? __ldcg(wcodes + k) : __ldg(sta + (s_sc_codes + k) * N + jc);
        for (int c = tid; c < cols; c += nt)
          if (stat_at(a_sc_codes + k, s_sc_codes + k, c) == code_j) state_add(d_sc_counts + k, c, inc);
      }
      // the term step: references with the commit bit, at L2; the codes and
      // the counts are loaded together, the store only where the code
      // matches the winner's
      for (int x = 0; x < nref; ++x) {
        const int e = refs[x];
        if (!(e & kRefCommit)) continue;
        const int k = e >> kRefShift;
        const int matched = row[c_match_by + k], anti = row[c_own_anti + k];
        const int code_j =
            kGlobal ? __ldcg(wcodes + sc + k) : __ldg(sta + (s_term_codes + k) * N + jc);
        const int* codes = g_codes + (size_t)k * N;
        int* counts = g_counts + (size_t)k * N;
        int* owners = g_owners + (size_t)k * N;
        for (int c = tid; c < cols; c += nt) {
          const int code = __ldg(codes + c);
          if (matched != 0) {
            const int x0 = __ldcg(counts + c);
            if (code == code_j) __stcg(counts + c, x0 + matched);
          }
          if (anti != 0) {
            const int x0 = __ldcg(owners + c);
            if (code == code_j) __stcg(owners + c, x0 + anti);
          }
        }
        if (tid == 0 && code_j < v) totals[k] += matched;
      }
      if (lead && tid == 0) assign[p] = jc;
    }
    __syncthreads();  // the round's buffers and facts are free for the next
  }

  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kSlices)
    for (int row = 0; row < d_term_counts; ++row)
      for (int c = tid; c < cols; c += nt) st[row * N + lo + c] = s_state[row * cpb + c];
  if constexpr (kMode == kOneCluster) {
    for (int c = tid; c < cols; c += nt) {
      const int j = lo + c;
      st[d_totals * N + j] = j < t ? totals[j] : 0;
    }
  } else if (q_in == 0) {
    // the shard's totals, from its first block (every block of a shard
    // keeps the same copy); the planes' totals row is left as it was, as
    // the reference's sharded scan leaves it
    for (int k = tid; k < t; k += nt) sh.totals[shard * t + k] = totals[k];
  }
  // no block leaves while another may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

template <bool kSv, bool kSlices>
__global__ void __launch_bounds__(kClusterThreads, 1)
solve_wide_kernel(const int* __restrict__ sc_meta, const int* __restrict__ pod_ints,
                  const float* __restrict__ pod_floats, const int* __restrict__ sta,
                  const float* __restrict__ sta_f, int* __restrict__ st,
                  int* __restrict__ assign, Dims d, Weights w, Plan pl) {
  wide_solve<kSv, kSlices, kOneCluster>(sc_meta, pod_ints, pod_floats, sta, sta_f, st, assign, d,
                                        w, pl, Shard{});
}

// ---------------------------------------------------------------------------
// The sharded kernel (see the note at the top): the wide kernel's body over
// the S shards, kMode the route: kGroups, every shard a block group of one
// cluster; kMesh, a cluster a shard with the exchange through global memory;
// kMeshHard, the same with the round of hard-spread domain minima (a batch
// whose constraints include a hard one), which kMesh does not compile.
template <bool kSv, bool kSlices, int kMode>
__global__ void __launch_bounds__(kClusterThreads, 1)
solve_sharded_kernel(const int* __restrict__ sc_meta, const int* __restrict__ pod_ints,
                     const float* __restrict__ pod_floats, const int* __restrict__ sta,
                     const float* __restrict__ sta_f, int* __restrict__ st,
                     int* __restrict__ assign, Dims d, Weights w, Plan pl, Shard sh) {
  wide_solve<kSv, kSlices, kMode>(sc_meta, pod_ints, pod_floats, sta, sta_f, st, assign, d, w,
                                  pl, sh);
}

// ---------------------------------------------------------------------------
// The batched static feasibility counts (see the note at the top). Block
// `rank` of a cluster owns columns [rank * 32 * words, +32 * words); cluster
// c counts pod tiles c, c + clusters, ... of 32 pods each, in chunks of up
// to kCountSlots tiles.
constexpr int kCountWarps = 8;
constexpr int kCountThreads = kCountWarps * 32;
constexpr int kCountCluster = 8;  // the portable size; more only where shared memory asks
constexpr int kCountSlots = 16;   // tiles a chunk

// Ints a staged pod row takes: its R requests and its profile, to 16 bytes.
__host__ __device__ inline int count_row_ints(int r) { return (r + 1 + 3) & ~3; }

// Shared memory of one block: alloc [R][32 * words], pod rows [2][slots][32]
// [row], mask words [U + 1][words] (row U empty), warp sums [slots][warps]
// [32], the block's sums [2][slots][32].
__host__ inline size_t count_smem_bytes(int r, int u, int words) {
  return sizeof(int) * ((size_t)r * 32 * words + 2 * kCountSlots * 32 * count_row_ints(r) +
                        (size_t)(u + 1) * words + kCountSlots * kCountWarps * 32 +
                        2 * kCountSlots * 32);
}

// kWide: R > 3 (the fourth request in registers too, any past it read from
// shared memory); else R <= 3, three compares a column.
template <bool kWide>
__global__ void __launch_bounds__(kCountThreads)
feasible_counts_kernel(const int* __restrict__ pod_ints, const int* __restrict__ sta,
                       int* __restrict__ counts, Dims d, int width, int words) {
  extern __shared__ int smem[];  // the dynamic base is 16-byte aligned
  cg::cluster_group cluster = cg::this_cluster();
  const int r = d.r, u = d.u, n = d.n, b = d.b;
  const size_t N = (size_t)n;
  const int rank = (int)cluster.block_rank(), ncl = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = count_row_ints(r), cols = 32 * words, lo = rank * cols;
  const int s_masks = r + 1, s_valid = r + 1 + u + d.sc + u * d.sc + d.t;
  int* alloc_s = smem;                                       // [R][cols]
  int* pods_s = alloc_s + (size_t)r * cols;                  // [2][slots][32][rs]
  unsigned* mask_s = (unsigned*)(pods_s + 2 * kCountSlots * 32 * rs);  // [U + 1][words]
  int* part_s = (int*)(mask_s + (size_t)(u + 1) * words);   // [slots][warps][32]
  int* tot_s = part_s + kCountSlots * kCountWarps * 32;     // [2][slots][32]
  const int tiles = (b + 31) / 32;
  const int first = (int)blockIdx.x / ncl, step = (int)gridDim.x / ncl;
  const int own = first < tiles ? (tiles - first + step - 1) / step : 0;  // this cluster's tiles
  const int chunks = (own + kCountSlots - 1) / kCountSlots;

  // the slice's alloc rows (static rows [0, R)), once
  const int ncols = max(0, min(n, lo + cols) - lo);
  for (int i = tid; i < r * ncols; i += kCountThreads) {
    const int k = i / ncols, c = i - k * ncols;
    cp_async4(alloc_s + k * cols + c, sta + k * N + lo + c);
  }
  cp_async_commit();
  // chunk `ch`'s pod rows (requests and profile) into buffer `buf`
  auto stage = [&](int ch, int buf) {
    const int nt = min(kCountSlots, own - ch * kCountSlots);
    int* dst = pods_s + buf * kCountSlots * 32 * rs;
    for (int i = tid; i < nt * 32 * (r + 1); i += kCountThreads) {
      const int q = i / (r + 1), k = i - q * (r + 1);  // q: slot * 32 + pod
      const int p = (first + step * (ch * kCountSlots + q / 32)) * 32 + (q & 31);
      if (p < b) cp_async4(dst + q * rs + k, pod_ints + (size_t)p * width + (k < r ? k : r + 2));
    }
  };
  if (chunks > 0) stage(0, 0);
  cp_async_commit();
  // each profile's mask and the validity row as one bit word per 32
  // columns (the loads of a few words in flight at once)
#pragma unroll 4
  for (int x = warp; x < u * words; x += kCountWarps) {
    const int p = x / words, k = x - p * words;
    const int c = lo + 32 * k + lane;
    const int valid = c < n ? __ldg(sta + s_valid * N + c) : 0;
    const int mask = c < n ? __ldg(sta + (s_masks + p) * N + c) : 0;
    const unsigned bits = __ballot_sync(0xffffffffu, valid > 0 && mask > 0);
    if (lane == 0) mask_s[x] = bits;
  }
  for (int k = tid; k < words; k += kCountThreads) mask_s[u * words + k] = 0u;

  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1, nt = min(kCountSlots, own - ch * kCountSlots);
    if (ch + 1 < chunks) stage(ch + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // the slice and this chunk have landed
    __syncthreads();
    for (int sl = 0; sl < nt; ++sl) {
      const int p0 = (first + step * (ch * kCountSlots + sl)) * 32, np = min(32, b - p0);
      // lane i owns pod p0 + i: its first four requests in registers (a
      // resource past R compares as always met), its profile's mask words
      // (the empty row for a profile outside [0, U) and past the batch)
      const int* mine_s = pods_s + ((buf * kCountSlots + sl) * 32 + lane) * rs;
      const int4 q4 = *reinterpret_cast<const int4*>(mine_s);
      const int q0 = q4.x, q1 = r > 1 ? q4.y : INT_MIN, q2 = r > 2 ? q4.z : INT_MIN,
                q3 = q4.w;
      const int prof = lane < np ? mine_s[r] : -1;
      const unsigned* mrow = mask_s + ((unsigned)prof < (unsigned)u ? prof : u) * words;
      int mine = 0;  // the pod's fits over this warp's words
      for (int k = warp; k < words; k += kCountWarps) {
        const unsigned mw = mrow[k];
        if (!__any_sync(0xffffffffu, mw != 0u)) continue;
        const int* col = alloc_s + 32 * k;
#pragma unroll
        for (int j = 0; j < 32; j += 4) {
          // four columns of each resource, one broadcast read each
          const int4 x0 = *reinterpret_cast<const int4*>(col + j);
          const int4 x1 = r > 1 ? *reinterpret_cast<const int4*>(col + cols + j) : x0;
          const int4 x2 = r > 2 ? *reinterpret_cast<const int4*>(col + 2 * cols + j) : x0;
          const int4 x3 = kWide ? *reinterpret_cast<const int4*>(col + 3 * cols + j) : x0;
          const int a[4][4] = {{x0.x, x1.x, x2.x, x3.x}, {x0.y, x1.y, x2.y, x3.y},
                               {x0.z, x1.z, x2.z, x3.z}, {x0.w, x1.w, x2.w, x3.w}};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool ok = (mw & (1u << (j + e))) && q0 <= a[e][0] && q1 <= a[e][1] &&
                      q2 <= a[e][2];
            if (kWide) {
              ok = ok && q3 <= a[e][3];
              for (int x = 4; x < r; ++x) ok = ok && mine_s[x] <= col[x * cols + j + e];
            }
            mine += ok;
          }
        }
      }
      part_s[(sl * kCountWarps + warp) * 32 + lane] = mine;
    }
    __syncthreads();
    // the block's sum a pod over its warps
    for (int i = tid; i < nt * 32; i += kCountThreads) {
      int x = 0;
#pragma unroll
      for (int w = 0; w < kCountWarps; ++w) x += part_s[((i >> 5) * kCountWarps + w) * 32 + (i & 31)];
      tot_s[buf * kCountSlots * 32 + i] = x;
    }
    // every block's sums for this chunk are in; a block writes this buffer
    // again two chunks on, after the next barrier, which rank 0 reaches
    // only once it has read them
    cluster.sync();
    if (rank == 0) {
      for (int i = tid; i < nt * 32; i += kCountThreads) {
        const int p = (first + step * (ch * kCountSlots + (i >> 5))) * 32 + (i & 31);
        if (p >= b) continue;
        int x = 0;
#pragma unroll 8
        for (int q = 0; q < ncl; ++q)
          x += *cluster.map_shared_rank(tot_s + buf * kCountSlots * 32 + i, q);
        counts[p] = x;
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while rank 0 may still read its sums
}

// The three cluster kernels share one signature.
using ClusterKernel = void (*)(const int*, const int*, const float*, const int*, const float*,
                               int*, int*, Dims, Weights, Plan);

// One cluster of `cluster` blocks, or `clusters` of them (the sharded kernel).
cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem_bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int clusters = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Fn>
cudaError_t set_cluster_attributes(Fn fn, int cluster, int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <typename Fn>
int max_active(Fn fn, int cluster, int threads, int smem_bytes) {
  cudaError_t e = set_cluster_attributes(fn, cluster, smem_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem_bytes, 0, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return count;
}

// min_chunk: the least pod chunk the kernel takes (the wide kernel reads
// rows in place at 0).
int launch_cluster(ClusterKernel fn, int layout_words, const int* sc_meta, const int* pod_ints,
                   const float* pod_floats, const int* static_ints, const float* static_f32s,
                   int* state, int* assign, Dims d, Plan p, int smem_bytes, Weights w,
                   void* stream, int min_chunk = 1) {
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.threads < 32 || p.threads % 32 != 0 ||
      p.threads > kClusterThreads || p.chunk < min_chunk || (long)p.cluster * p.cpb < d.n ||
      layout_words * (int)sizeof(int) != smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_cluster_attributes(fn, p.cluster, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(p.cluster, p.threads, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, fn, sc_meta, pod_ints, pod_floats, static_ints, static_f32s, state,
                         assign, d, w, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

using ShardedKernel = void (*)(const int*, const int*, const float*, const int*, const float*,
                               int*, int*, Dims, Weights, Plan, Shard);

// The sharded kernel's instances: [sv][slices][route: one cluster, global,
// global with the hard round].
#define KTT_SHARDED_ROUTES(sv, sl)                                               \
  {solve_sharded_kernel<sv, sl, kGroups>, solve_sharded_kernel<sv, sl, kMesh>, \
   solve_sharded_kernel<sv, sl, kMeshHard>}
const ShardedKernel kShardedKernels[2][2][3] = {
    {KTT_SHARDED_ROUTES(false, false), KTT_SHARDED_ROUTES(false, true)},
    {KTT_SHARDED_ROUTES(true, false), KTT_SHARDED_ROUTES(true, true)}};
#undef KTT_SHARDED_ROUTES

// The fewest clusters of this shape any instance of the sharded kernel fits
// at once; a negative value is a CUDA error.
int sharded_max_active(int cluster, int threads, int smem_bytes) {
  int fewest = INT_MAX;
  for (int sv = 0; sv < 2; ++sv)
    for (int sl = 0; sl < 2; ++sl)
      for (int h = 0; h < 3; ++h) {
        const int count = max_active(kShardedKernels[sv][sl][h], cluster, threads, smem_bytes);
        if (count < 0) return count;
        fewest = count < fewest ? count : fewest;
      }
  return fewest;
}

}  // namespace

// Shared-memory bytes of the cluster kernel for a plan.
extern "C" int ktt_cluster_smem_bytes(int r, int sc, int t, int u, int sv, int cluster,
                                      int threads, int cpb, int chunk) {
  Dims d{r, sc, t, u, 0, sv, 0, 0};
  Plan p{cluster, threads, cpb, chunk};
  return cluster_layout(d, p).words * (int)sizeof(int);
}

// Shared-memory bytes of the slot kernel for a plan.
extern "C" int ktt_slots_smem_bytes(int r, int sc, int t, int u, int sv, int cluster,
                                    int threads, int cpb, int chunk) {
  Dims d{r, sc, t, u, 0, sv, 0, 0};
  Plan p{cluster, threads, cpb, chunk};
  return slots_layout(d, p).words * (int)sizeof(int);
}

// How many clusters of this shape the card can hold at once (0: none, so
// the shape cannot launch); a negative value is a CUDA error.
extern "C" int ktt_cluster_max_active(int cluster, int threads, int smem_bytes) {
  // one plan serves both instances: the fewer clusters either one fits
  const int with_sv = max_active(solve_cluster_kernel<true>, cluster, threads, smem_bytes);
  const int without = max_active(solve_cluster_kernel<false>, cluster, threads, smem_bytes);
  if (with_sv < 0) return with_sv;
  if (without < 0) return without;
  return with_sv < without ? with_sv : without;
}

// The same for the slot kernel.
extern "C" int ktt_slots_max_active(int cluster, int threads, int smem_bytes) {
  return max_active(solve_slots_kernel, cluster, threads, smem_bytes);
}

// Shared-memory bytes of the wide kernel for a plan, in the tier the plan
// gets (wide_slices).
extern "C" int ktt_wide_smem_bytes(int r, int sc, int t, int u, int sv, int cluster, int threads,
                                   int cpb, int chunk) {
  Dims d{r, sc, t, u, 0, sv, 0, 0};
  Plan p{cluster, threads, cpb, chunk};
  return wide_layout(d, p, wide_slices(d, p)).words * (int)sizeof(int);
}

// The same for the wide kernel: the fewest clusters any of its four
// instances fits.
extern "C" int ktt_wide_max_active(int cluster, int threads, int smem_bytes) {
  const ClusterKernel fns[] = {solve_wide_kernel<false, true>, solve_wide_kernel<true, true>,
                               solve_wide_kernel<false, false>, solve_wide_kernel<true, false>};
  int fewest = INT_MAX;
  for (ClusterKernel fn : fns) {
    const int count = max_active(fn, cluster, threads, smem_bytes);
    if (count < 0) return count;
    fewest = count < fewest ? count : fewest;
  }
  return fewest;
}

// Launch the cluster solve on `stream`: one cluster of `cluster` blocks,
// planes updated in place. Returns the CUDA error of the launch (0 when it
// was accepted); a plan the kernel cannot run is refused as an invalid value.
extern "C" int ktt_solve_cluster_launch(const int* sc_meta, const int* pod_ints,
                                        const float* pod_floats, const int* static_ints,
                                        const float* static_f32s, int* state, int* assign, int r,
                                        int sc, int t, int u, int v, int sv, int n, int b,
                                        int cluster, int threads, int cpb, int chunk,
                                        int smem_bytes, float balanced_w, float least_w,
                                        float spread_w, float affinity_w, float static_w,
                                        void* stream) {
  Dims d{r, sc, t, u, v, sv, n, b};
  Plan p{cluster, threads, cpb, chunk};
  return launch_cluster(sv > 0 ? solve_cluster_kernel<true> : solve_cluster_kernel<false>,
                        cluster_layout(d, p).words, sc_meta, pod_ints,
                        pod_floats, static_ints, static_f32s, state, assign, d, p, smem_bytes,
                        Weights{balanced_w, least_w, spread_w, affinity_w, static_w}, stream);
}

// Launch the slot solve on `stream` with the slot stream as the pod rows
// ([B, R+4+2*SC+2*K] ints, [B, K] weights); otherwise as the cluster solve.
// The slot stream has no shared-volume columns: planes with sv > 0 are
// refused as an invalid value.
extern "C" int ktt_solve_slots_launch(const int* sc_meta, const int* pod_ints,
                                      const float* pod_floats, const int* static_ints,
                                      const float* static_f32s, int* state, int* assign, int r,
                                      int sc, int t, int u, int v, int sv, int n, int b,
                                      int cluster, int threads, int cpb, int chunk,
                                      int smem_bytes, float balanced_w, float least_w,
                                      float spread_w, float affinity_w, float static_w,
                                      void* stream) {
  if (sv != 0) return (int)cudaErrorInvalidValue;
  Dims d{r, sc, t, u, v, sv, n, b};
  Plan p{cluster, threads, cpb, chunk};
  // the cache copies 16 bytes at a time: four columns, 16-byte aligned rows
  const int words = slots_layout(d, p).words;
  if (n % 4 != 0 || cpb % 4 != 0 || chunk > 32 || (reinterpret_cast<size_t>(state) & 15) != 0 ||
      (reinterpret_cast<size_t>(static_ints) & 15) != 0 ||
      (long)words * (long)sizeof(int) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return launch_cluster(solve_slots_kernel, words, sc_meta, pod_ints,
                        pod_floats, static_ints, static_f32s, state, assign, d, p, smem_bytes,
                        Weights{balanced_w, least_w, spread_w, affinity_w, static_w}, stream);
}

// Launch the wide solve on `stream` with the dense pod stream, as the
// cluster solve; the plan's chunk may be 0 (rows read in place), and its
// byte count says the tier (wide_slices) with the layout's.
extern "C" int ktt_solve_wide_launch(const int* sc_meta, const int* pod_ints,
                                     const float* pod_floats, const int* static_ints,
                                     const float* static_f32s, int* state, int* assign, int r,
                                     int sc, int t, int u, int v, int sv, int n, int b,
                                     int cluster, int threads, int cpb, int chunk, int smem_bytes,
                                     float balanced_w, float least_w, float spread_w,
                                     float affinity_w, float static_w, void* stream) {
  Dims d{r, sc, t, u, v, sv, n, b};
  Plan p{cluster, threads, cpb, chunk};
  const bool slices = wide_slices(d, p);
  ClusterKernel fn = sv > 0 ? (slices ? solve_wide_kernel<true, true> : solve_wide_kernel<true, false>)
                            : (slices ? solve_wide_kernel<false, true> : solve_wide_kernel<false, false>);
  return launch_cluster(fn, wide_layout(d, p, slices).words, sc_meta, pod_ints, pod_floats,
                        static_ints, static_f32s, state, assign, d, p, smem_bytes,
                        Weights{balanced_w, least_w, spread_w, affinity_w, static_w}, stream, 0);
}

// Shared-memory bytes of the sharded kernel for a plan over one shard's
// columns, in the tier the plan gets (sharded_slices).
extern "C" int ktt_sharded_smem_bytes(int r, int sc, int t, int u, int sv, int cluster,
                                      int threads, int cpb, int chunk) {
  Dims d{r, sc, t, u, 0, sv, 0, 0};
  Plan p{cluster, threads, cpb, chunk};
  return sharded_layout(d, p, sharded_slices(d, p)).words * (int)sizeof(int);
}

// The same for the sharded kernel: the fewest clusters of this shape any of
// its twelve instances fits at once.
extern "C" int ktt_sharded_max_active(int cluster, int threads, int smem_bytes) {
  return sharded_max_active(cluster, threads, smem_bytes);
}

// Words of the sharded kernel's exchange workspace (sharded_workspace),
// given on either route; the one-cluster route reads and writes none of it,
// so its error word stays as the caller zeroed it.
extern "C" int ktt_sharded_workspace_words(int shards, int sc, int t) {
  return sharded_workspace(shards, sc, t).words;
}

// Launch the sharded solve on `stream`, shard s over columns [s * n /
// shards, (s + 1) * n / shards). The plan's cut names the route: where its
// cluster holds g = cluster / shards blocks a shard that cover a shard's
// columns, one cluster, shard s on blocks [s * g, (s + 1) * g), exchanging
// in distributed shared memory (`ws` untouched); else `shards` clusters of
// the plan's blocks, cluster s on shard s, each pod's best exchanged
// through `ws` (ktt_sharded_workspace_words words on either route). `ws` is
// zeroed by the caller on the stream before the launch. The state planes
// are updated in place but for their totals row; the shards' totals ([S,
// T]) are read and written in `totals`. Refused (an invalid value) when the
// plan or the workspace does not match, and refused
// (cudaErrorCooperativeLaunchTooLarge) when the card cannot hold all the
// clusters at once, since a cluster waiting for one not yet running would
// spin: every launch checks it. `launched` of the global route's clusters
// run (shards but in the tests' launch below, which the one-cluster route
// refuses).
static int sharded_launch(const int* sc_meta, const int* pod_ints, const float* pod_floats,
                          const int* static_ints, const float* static_f32s, int* state,
                          int* assign, const int* has_dom, int* totals, int* ws, int ws_words,
                          int r, int sc, int t, int u, int v, int sv, int n, int b, int shards,
                          int hard, int cluster, int threads, int cpb, int chunk, int smem_bytes,
                          Weights w, void* stream, int launched) {
  Dims d{r, sc, t, u, v, sv, n, b};
  Plan p{cluster, threads, cpb, chunk};
  if (shards < 1 || shards > 32 || n % shards != 0) return (int)cudaErrorInvalidValue;
  const int nl = n / shards;
  const bool slices = sharded_slices(d, p);
  const bool groups =
      p.cluster % shards == 0 && (long)(p.cluster / shards) * p.cpb >= nl;  // one cluster
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.threads < 32 || p.threads % 32 != 0 ||
      p.threads > kClusterThreads || p.chunk < 0 || (long)p.cluster * p.cpb < nl ||
      sharded_layout(d, p, slices).words * (int)sizeof(int) != smem_bytes ||
      sharded_workspace(shards, sc, t).words != ws_words ||
      (groups && launched != shards))
    return (int)cudaErrorInvalidValue;
  ShardedKernel fn = kShardedKernels[sv > 0][slices][groups ? 0 : hard != 0 ? 2 : 1];
  const int active = max_active(fn, p.cluster, p.threads, smem_bytes);
  if (active < 0) return -active;
  if (active < (groups ? 1 : shards)) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(p.cluster, p.threads, smem_bytes,
                                          static_cast<cudaStream_t>(stream), &attr,
                                          groups ? 1 : launched);
  cudaError_t e = cudaLaunchKernelEx(&cfg, fn, sc_meta, pod_ints, pod_floats, static_ints,
                                     static_f32s, state, assign, d, w, p,
                                     Shard{shards, nl, has_dom, totals, ws});
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int ktt_solve_sharded_launch(const int* sc_meta, const int* pod_ints,
                                        const float* pod_floats, const int* static_ints,
                                        const float* static_f32s, int* state, int* assign,
                                        const int* has_dom, int* totals, int* ws, int ws_words,
                                        int r, int sc, int t, int u, int v, int sv, int n, int b,
                                        int shards, int hard, int cluster, int threads, int cpb,
                                        int chunk, int smem_bytes, float balanced_w,
                                        float least_w, float spread_w, float affinity_w,
                                        float static_w, void* stream) {
  return sharded_launch(sc_meta, pod_ints, pod_floats, static_ints, static_f32s, state, assign,
                        has_dom, totals, ws, ws_words, r, sc, t, u, v, sv, n, b, shards, hard,
                        cluster, threads, cpb, chunk, smem_bytes,
                        Weights{balanced_w, least_w, spread_w, affinity_w, static_w}, stream,
                        shards);
}

// The same launch with the last shard's cluster left out of the grid, so
// that every poll for its flag runs out: the tests' hold on the poll's bound
// and the error word (needs shards >= 2 on the global route).
extern "C" int ktt_solve_sharded_launch_one_short(
    const int* sc_meta, const int* pod_ints, const float* pod_floats, const int* static_ints,
    const float* static_f32s, int* state, int* assign, const int* has_dom, int* totals, int* ws,
    int ws_words, int r, int sc, int t, int u, int v, int sv, int n, int b, int shards, int hard,
    int cluster, int threads, int cpb, int chunk, int smem_bytes, float balanced_w, float least_w,
    float spread_w, float affinity_w, float static_w, void* stream) {
  if (shards < 2) return (int)cudaErrorInvalidValue;
  return sharded_launch(sc_meta, pod_ints, pod_floats, static_ints, static_f32s, state, assign,
                        has_dom, totals, ws, ws_words, r, sc, t, u, v, sv, n, b, shards, hard,
                        cluster, threads, cpb, chunk, smem_bytes,
                        Weights{balanced_w, least_w, spread_w, affinity_w, static_w}, stream,
                        shards - 1);
}

using CountKernel = void (*)(const int*, const int*, int*, Dims, int, int);

// Launch the feasibility counts on `stream`, which writes `counts` ([B]
// int32) whole. The mesh (`shards` node slices of n / shards columns,
// `batch_axis` slices of the batch) must split the problem, as the
// reference's shard_map requires; the counts do not depend on it.
extern "C" int ktt_feasible_counts_launch(const int* pod_ints, const int* static_ints, int* counts,
                                          int r, int sc, int t, int u, int n, int b, int width,
                                          int shards, int batch_axis, void* stream) {
  if (shards < 1 || batch_axis < 1 || n % shards != 0 || b % batch_axis != 0 || r < 1 || u < 0 ||
      width < r + 3)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  // the smallest cluster that leaves each warp at most two words of its
  // slice, up to the portable 8; past that only where shared memory asks
  const int all_words = (n + 31) / 32;
  int cluster = 1;
  while (cluster < kCountCluster && all_words > cluster * 2 * kCountWarps) cluster *= 2;
  int words = (all_words + cluster - 1) / cluster;
  size_t smem = count_smem_bytes(r, u, words);
  while (smem > (size_t)kSmemLimit && cluster < kMaxCluster) {
    cluster *= 2;
    words = (all_words + cluster - 1) / cluster;
    smem = count_smem_bytes(r, u, words);
  }
  if (smem > (size_t)kSmemLimit || words < 1) return (int)cudaErrorInvalidValue;
  // as many clusters as the card holds at once (each loads its slices
  // once), no more than the tiles; max_active also sets the instance's
  // cluster attributes
  const CountKernel fn = r > 3 ? feasible_counts_kernel<true> : feasible_counts_kernel<false>;
  const int held = max_active(fn, cluster, kCountThreads, (int)smem);
  if (held < 1) return held < 0 ? -held : (int)cudaErrorInvalidValue;
  const int clusters = min((b + 31) / 32, held);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cluster, kCountThreads, (int)smem,
                                          static_cast<cudaStream_t>(stream), &attr, clusters);
  Dims d{r, sc, t, u, 0, 0, n, b};
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, fn, pod_ints, static_ints, counts, d, width, words);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
